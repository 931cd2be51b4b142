"""File read-ahead on a thread, and the sequential-access OS hint.

Analog of the reference's PrefetchReader (crates/fgumi-bam-io/src/
prefetch_reader.rs:93) and its POSIX_FADV_SEQUENTIAL hint (src/
os_hints.rs): a daemon thread reads fixed-size chunks ahead of the consumer
into a bounded queue, so the disk's latency overlaps inflate and decode
even where a command runs without a reader stage of its own.

``FGUMI_TPU_NO_PREFETCH=1`` turns it off.
"""

import logging
import os
import queue
import threading

from ..observe import trace as _trace
from ..observe.scope import spawn_thread

log = logging.getLogger("fgumi_tpu_torch")

_EOF = object()


def advise_sequential(fileobj):
    """POSIX_FADV_SEQUENTIAL on a real file, where the platform has it."""
    try:
        os.posix_fadvise(fileobj.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
    except (AttributeError, OSError, ValueError):
        pass  # not a real file, or no fadvise here


def prefetch_enabled() -> bool:
    """False under ``FGUMI_TPU_NO_PREFETCH`` set to 1, true or yes."""
    return os.environ.get("FGUMI_TPU_NO_PREFETCH", "").lower() \
        not in ("1", "true", "yes")


class PrefetchFile:
    """Read-only file wrapper with a read-ahead thread.

    Serves ``read(n)`` from a queue of ``chunk``-sized blocks that a daemon
    thread reads ahead, at most ``depth`` of them, so its memory stays
    within ``depth * chunk`` bytes. A read error on the thread is raised
    by the consumer's next ``read()``; it is never swallowed.
    """

    def __init__(self, fileobj, chunk: int = 1 << 20, depth: int = 4,
                 owns_fileobj: bool = True):
        self._f = fileobj
        self._owns = owns_fileobj
        self.name = getattr(fileobj, "name", None)
        self._q = queue.Queue(maxsize=depth)
        self._buf = memoryview(b"")
        self._eof = False
        self._exc = None
        self._stop = threading.Event()
        advise_sequential(fileobj)
        # the read-ahead thread records its io.prefetch.read spans into the
        # opening command's telemetry scope
        self._trace_on = _trace.tracing_enabled()
        self._t = spawn_thread(self._loop, args=(chunk,),
                               name="fgumi-prefetch")
        self._t.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _loop(self, chunk):
        try:
            while not self._stop.is_set():
                with _trace.span("io.prefetch.read") \
                        if self._trace_on else _trace.NULL_SPAN:
                    data = self._f.read(chunk)
                if not self._put(data if data else _EOF) or not data:
                    return
        except BaseException as e:  # noqa: BLE001 - raised by read()
            self._exc = e
            self._put(_EOF)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                got = self.read(1 << 20)
                if not got:
                    return b"".join(parts)
                parts.append(got)
        out = bytearray()
        while len(out) < n:
            if self._buf:
                take = min(n - len(out), len(self._buf))
                out += self._buf[:take]
                self._buf = self._buf[take:]
                continue
            if self._eof:
                break
            got = self._q.get()
            if got is _EOF:
                self._eof = True
                if self._exc is not None:
                    exc, self._exc = self._exc, None
                    raise exc
                break
            if not out and len(got) <= n:
                # the steady state (the consumer reads what the thread
                # reads): hand the queued bytes over without a copy
                return got
            self._buf = memoryview(got)
        return bytes(out)

    def fileno(self):
        return self._f.fileno()

    def close(self):
        self._stop.set()
        # drain, so the thread cannot stay blocked on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5)
        if self._exc is not None:
            # an error the consumer never read far enough to meet (the
            # data it did get may be short): log it rather than drop it
            exc, self._exc = self._exc, None
            log.warning("prefetch: read error of %s never reached the "
                        "reader: %r", self.name or "<file>", exc)
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
