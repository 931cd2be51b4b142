"""Fused streaming chain: in-memory stage handoff for the pipeline command.

Adjacent stages of ``pipeline`` (extract ⇒ sort ⇒ group ⇒ simplex ⇒
filter) hand off uncompressed BAM *wire chunks* (block_size-prefixed record
runs, exactly the bytes a level-0 intermediate would carry between its BGZF
frames) through a bounded in-memory channel, so

- the producer's serialized output feeds the consumer with no BGZF encode,
  no file write, no file read and no BGZF decode in between;
- stages overlap (each runs on its own thread, blocking on the channel's
  byte budget for backpressure);
- the records equal the staged run's by construction: the handed-off bytes
  are the record wire bytes a file round trip would deliver, and headers
  travel through an encode → decode round trip, so header-derived
  provenance (@HD rewrites, @PG chaining) sees what a file would give.

Three pieces, topology-free (the topology lives in ``cli.cmd_pipeline``):

- :class:`ChainChannel` — the bounded, byte-budgeted blob queue with
  backpressure and abort/cancel propagation in both directions;
- :class:`ChannelBamWriter` — a ``BamWriter``-compatible sink writing into
  a channel;
- :class:`ChannelBatchReader` — a ``BamBatchReader``-compatible source
  assembling channel blobs into :class:`~fgumi_tpu_torch.io.batch_reader.
  RecordBatch` objects with the file reader's own assembler, so re-chunking
  behaves the same.
"""

import io
import logging
import os
import struct
import threading
import time
from collections import deque

import numpy as np

from .observe.metrics import METRICS
from .utils.governor import GOVERNOR, DynamicBudget

log = logging.getLogger("fgumi_tpu_torch")

#: Default per-channel byte budget: two wire chunks of the default 16 MiB
#: batch target fit with headroom; FGUMI_TPU_CHAIN_BYTES overrides it.
DEFAULT_CHANNEL_BYTES = 64 << 20


def channel_bytes_budget() -> int:
    """Per-channel byte budget: ``FGUMI_TPU_CHAIN_BYTES`` or the default."""
    raw = os.environ.get("FGUMI_TPU_CHAIN_BYTES", "")
    if not raw.strip():
        return DEFAULT_CHANNEL_BYTES
    try:
        n = int(raw)
        if n <= 0:
            raise ValueError
        return n
    except ValueError:
        log.warning("FGUMI_TPU_CHAIN_BYTES=%s: not a positive integer; "
                    "using default %d", raw, DEFAULT_CHANNEL_BYTES)
        return DEFAULT_CHANNEL_BYTES


class ChainAborted(RuntimeError):
    """The stage at the *other* end of a channel failed (or the pipeline
    cancelled the run), so this stage unwinds quietly: a cascade victim,
    not the root cause. Stage runners report it as "aborted"."""


def header_roundtrip(header):
    """The header exactly as a file round trip would deliver it."""
    from .io.bam import BamHeader

    return BamHeader.decode_from(io.BytesIO(header.encode()).read)


class ChainChannel:
    """Bounded in-memory handoff between two pipeline stages.

    Carries a header (published once by the producer, awaited by the
    consumer) followed by a stream of wire-chunk blobs (``bytes``,
    ``bytearray`` or uint8 ``ndarray``). Producers block while admitting
    another blob would exceed the byte budget — except that one blob is
    always admitted, so an oversized chunk degrades to serial flow instead
    of deadlocking.

    Failure propagates both ways: :meth:`abort` (the producer died) makes
    every consumer call raise :class:`ChainAborted`; :meth:`cancel` (the
    consumer died) makes every producer call raise it. Both are idempotent
    and keep the first reason.

    The limit is a :class:`~fgumi_tpu_torch.utils.governor.DynamicBudget`:
    the default one registers with the process's governor, which may move
    bytes to a contended channel from idle ones; an explicit ``max_bytes``
    stays static. Under a hard resource watermark every put raises
    :class:`~fgumi_tpu_torch.utils.governor.ResourceExhausted`.
    """

    def __init__(self, name: str, max_bytes: int = None):
        self.name = name
        if max_bytes is None:
            self._budget = DynamicBudget(f"chain.{name}",
                                         channel_bytes_budget())
            self._gov_token = GOVERNOR.register_budget(
                self._budget, demand_fn=self._demand)
        else:
            self._budget = DynamicBudget(f"chain.{name}", int(max_bytes),
                                         damp_s=0.0)
            self._gov_token = None
        # a grown budget releases the producers already blocked on it
        self._budget.on_resize = self._notify_waiters
        self._cv = threading.Condition()
        self._header = None
        self._have_header = False
        self._blobs = deque()  # FIFO
        self._bytes = 0
        self._closed = False
        self._cancelled = False
        self._abort_reason = None
        self.n_blobs = 0
        self.total_bytes = 0
        self.peak_bytes = 0
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0
        self._metrics_folded = False
        # hoisted: a fire() costs a lock and an environment read per blob
        from .observe import trace as _trace
        from .utils import faults

        self._fault_armed = faults.armed("chain.handoff")
        self._trace_on = _trace.tracing_enabled()

    @property
    def max_bytes(self) -> int:
        """The byte budget now (the governor may have resized it)."""
        return self._budget.limit

    def _demand(self) -> dict:
        """The governor's demand signal: a growing put wait is a starved
        producer, a growing get wait a starved consumer (a donor)."""
        return {"put_wait_s": self.put_wait_s,
                "get_wait_s": self.get_wait_s}

    def _notify_waiters(self):
        with self._cv:
            self._cv.notify_all()

    def _ungovern(self):
        GOVERNOR.unregister_budget(self._gov_token)
        self._gov_token = None

    # ------------------------------------------------------------- producer

    def put_header(self, header) -> None:
        """Publish the stream header (a ``BamHeader``) as a file round trip
        would deliver it."""
        hdr = header_roundtrip(header)
        with self._cv:
            if self._cancelled or self._abort_reason is not None:
                raise ChainAborted(self._reason_locked())
            self._header = hdr
            self._have_header = True
            self._cv.notify_all()

    def put(self, blob) -> None:
        """Hand one wire-chunk blob to the consumer (blocks on the byte
        budget; ownership transfers — the producer must not reuse a
        mutable blob after putting it)."""
        if self._fault_armed:
            from .utils import faults

            blob = faults.fire("chain.handoff", blob)
            if blob is None:
                return
        n = len(blob)
        if n == 0:
            # the consumer's assembler reads an empty chunk as end of
            # stream: never enqueue one
            return
        if self._trace_on:
            from .observe.trace import span

            with span("chain.put", channel=self.name, bytes=n):
                self._put(blob, n)
        else:
            self._put(blob, n)

    def _put(self, blob, n: int) -> None:
        t0 = time.monotonic()
        with self._cv:
            # a hard watermark ends the producing stage cleanly (exit 4, the
            # chain's abort cascade) instead of queueing into an OOM or a
            # full disk
            GOVERNOR.check_hard()
            while (self._bytes > 0 and self._bytes + n > self.max_bytes
                   and not self._cancelled
                   and self._abort_reason is None):
                self._cv.wait(0.1)
                GOVERNOR.check_hard()
            if self._cancelled or self._abort_reason is not None:
                raise ChainAborted(self._reason_locked())
            if self._closed:
                raise RuntimeError(
                    f"chain channel {self.name}: put after close")
            self._blobs.append(blob)
            self._bytes += n
            self.n_blobs += 1
            self.total_bytes += n
            self.peak_bytes = max(self.peak_bytes, self._bytes)
            wait = time.monotonic() - t0
            self.put_wait_s += wait
            self._cv.notify_all()
        # outside the channel lock: the registry's lock must not extend
        # this condition's critical section
        METRICS.observe("pipeline.chain.put_wait_s", wait)

    def close(self) -> None:
        """Producer EOF: the consumer drains remaining blobs, then sees end
        of stream. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._ungovern()  # no more puts: stop competing for the cap

    def abort(self, reason: str) -> None:
        """Producer-side failure: every pending and future consumer call
        raises :class:`ChainAborted`. Idempotent (first reason wins)."""
        with self._cv:
            if self._abort_reason is None:
                self._abort_reason = reason
            self._closed = True
            self._blobs.clear()
            self._bytes = 0
            self._cv.notify_all()
        self._ungovern()

    # ------------------------------------------------------------- consumer

    @property
    def has_header(self) -> bool:
        """True once the producer published the header (never blocks)."""
        return self._have_header

    @property
    def header(self):
        """The stream's ``BamHeader`` (blocks until the producer publishes;
        raises :class:`ChainAborted` if it never will)."""
        with self._cv:
            while not self._have_header:
                if self._abort_reason is not None or self._cancelled:
                    raise ChainAborted(self._reason_locked())
                if self._closed:
                    raise ChainAborted(
                        f"chain channel {self.name}: closed with no header")
                self._cv.wait(0.1)
            return self._header

    def get(self):
        """Next blob, or None at end of stream."""
        t0 = time.monotonic()
        with self._cv:
            while True:
                if self._abort_reason is not None or self._cancelled:
                    raise ChainAborted(self._reason_locked())
                if self._blobs:
                    blob = self._blobs.popleft()
                    self._bytes -= len(blob)
                    wait = time.monotonic() - t0
                    self.get_wait_s += wait
                    self._cv.notify_all()
                    break
                if self._closed:
                    self.get_wait_s += time.monotonic() - t0
                    return None
                self._cv.wait(0.1)
        METRICS.observe("pipeline.chain.get_wait_s", wait)
        return blob

    def cancel(self) -> None:
        """Consumer-side failure or early exit: every blocked or future
        producer call raises :class:`ChainAborted`; buffered blobs are
        dropped. Idempotent."""
        with self._cv:
            self._cancelled = True
            self._blobs.clear()
            self._bytes = 0
            self._cv.notify_all()
        self._ungovern()

    def _reason_locked(self) -> str:
        if self._abort_reason is not None:
            return self._abort_reason
        return f"chain channel {self.name}: consumer cancelled"

    def fold_metrics(self) -> None:
        """Fold the channel's counters into ``METRICS`` under
        ``pipeline.chain.<name>.*`` (once; the fused pipeline calls it in its
        ``finally``, so a failed run reports too)."""
        if self._metrics_folded:
            return
        self._metrics_folded = True
        p = f"pipeline.chain.{self.name}"
        METRICS.inc(f"{p}.batches", self.n_blobs)
        METRICS.inc(f"{p}.bytes", self.total_bytes)
        METRICS.max(f"{p}.peak_bytes", self.peak_bytes)
        METRICS.inc(f"{p}.put_wait_s", round(self.put_wait_s, 6))
        METRICS.inc(f"{p}.get_wait_s", round(self.get_wait_s, 6))
        METRICS.set(f"{p}.budget_limit", self.max_bytes)
        if self._budget.grows or self._budget.shrinks:
            METRICS.inc(f"{p}.budget_grows", self._budget.grows)
            METRICS.inc(f"{p}.budget_shrinks", self._budget.shrinks)

    def stats(self) -> dict:
        """The channel's counters (blobs, bytes, peak, waits)."""
        return {"batches": self.n_blobs, "bytes": self.total_bytes,
                "peak_bytes": self.peak_bytes, "budget": self.max_bytes,
                "put_wait_s": self.put_wait_s, "get_wait_s": self.get_wait_s}


class ChannelBamWriter:
    """``BamWriter``-compatible sink writing wire chunks into a channel.

    Small writes coalesce into ~``chunk_bytes`` blobs (one channel handoff
    per chunk, not per record); blobs already at or above the chunk size
    pass through with no copy after the pending buffer flushes.
    """

    def __init__(self, channel: ChainChannel, header,
                 chunk_bytes: int = 1 << 20):
        self._chan = channel
        self._chunk_bytes = int(chunk_bytes)
        self._buf = bytearray()
        self._closed = False
        channel.put_header(header)

    def write_record_bytes(self, data: bytes) -> None:
        self._buf += struct.pack("<I", len(data))
        self._buf += data
        if len(self._buf) >= self._chunk_bytes:
            self._flush()

    def write_serialized(self, blob) -> None:
        """Append records already carrying their block_size prefixes."""
        if len(blob) >= self._chunk_bytes:
            self._flush()
            self._chan.put(blob)
            return
        self._buf += memoryview(blob)
        if len(self._buf) >= self._chunk_bytes:
            self._flush()

    def _flush(self) -> None:
        if self._buf:
            # a fresh bytearray (the channel owns it from here), so the
            # consumer can wrap it writable without a second copy
            self._chan.put(bytearray(self._buf))
            self._buf.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._flush()
        self._chan.close()

    def discard(self) -> None:
        """Abandon the stream (error path): the consumer sees an abort, not
        a truncated-looking end of stream."""
        if self._closed:
            return
        self._closed = True
        self._buf.clear()
        self._chan.abort(
            f"chain channel {self._chan.name}: producer discarded output")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.discard()


class ChannelBatchReader:
    """``BamBatchReader``-compatible source decoding channel blobs into
    RecordBatch objects.

    Re-chunks the producer's blob stream to ``target_bytes`` batches with
    the file reader's accumulate → boundary-scan → tail-carry assembler.
    With ``writable=True`` (the default) read-only blobs (plain ``bytes``)
    are copied once, because simplex's overlap correction edits
    ``RecordBatch.buf`` in place; a consumer that only reads its batches
    (sort ingest, group) passes ``writable=False`` and skips that copy.
    """

    def __init__(self, channel: ChainChannel, target_bytes: int = 16 << 20,
                 writable: bool = True):
        from .io.batch_reader import _BatchAssembler

        self._chan = channel
        self._writable = writable
        self._asm = _BatchAssembler(self._read_chunk, target_bytes)
        self._exhausted = False
        self.copies = 0

    @property
    def header(self):
        return self._chan.header

    def _read_chunk(self) -> np.ndarray:
        blob = self._chan.get()
        if blob is None:
            self._exhausted = True
            return np.empty(0, dtype=np.uint8)
        if isinstance(blob, np.ndarray):
            return blob
        arr = np.frombuffer(blob, dtype=np.uint8)
        if self._writable and not arr.flags.writeable:
            arr = arr.copy()
            self.copies += 1
        return arr

    def __iter__(self):
        return iter(self._asm)

    def close(self) -> None:
        if not self._exhausted:
            # early exit (this stage failed): release a producer blocked
            # on the byte budget
            self._chan.cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
