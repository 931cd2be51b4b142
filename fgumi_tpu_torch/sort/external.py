"""External merge sort for BAM records, on the native sort engine.

Analog of the reference's crates/fgumi-sort (RawExternalSorter,
external.rs:1594): phase 1 accumulates record batches to a memory budget,
sorts them by their packed keys (sort/keys.py) and spills sorted runs;
phase 2 k-way merges the runs. Records and keys accumulate in two
contiguous byte pools with span tables, and the hot phases run in C++
(native/fgumi_native.cc): argsort by (memcmp, ingest order) over spans,
permutation gather, spill runs written natively, and a heap k-way merge
streaming wire chunks back (the analog of radix_sort_record_refs +
LoserTree, fgumi-sort/src/inline.rs:1642, loser_tree.rs:34). Records stay
block_size-prefixed (BAM wire form), so sorted output goes straight to
``BamWriter.write_serialized`` or a pipeline channel.

With ``spill_workers`` (``sort --threads N``: N - 1 workers) completed
pools are sorted and written on worker threads while ingest goes on (the
native calls release the GIL), and with two or more the merge reads each
run's next frame on a prefetch pool (``fgumi_merge_open2``), as the
reference's worker pool does (fgumi-sort/src/worker_pool.rs). Neither
changes the output: a run's slot is fixed when it is submitted.

Under the resource governor (``utils/governor.py``) the spill directory is
watched against the disk watermarks, soft pressure spills a pool early and
turns the merge's prefetch off (``merge_prefetch_bytes``), a hard
watermark stops the sort before its next spill, and a full disk during a
spill ends it with ``ResourceExhausted`` (exit 4); ``close`` removes every
run either way.

Spill runs are stored frames: they never reach the output and are read
back once, and this build links no compression library.

Telemetry: each spill is a ``sort.spill`` span (on the thread that writes
it) with the ``sort.spill_s`` histogram and the ``sort.spill`` fault point
(kind ``enospc`` proves the exit-4 contract); ``sort.merge_frame_s`` times
each wire chunk the native merge hands back.
"""

import contextvars
import os
import tempfile
import time

import numpy as np

from ..core.template import library_lookup_from_header
from ..io.bam import RawRecord
from ..native import get_lib
from ..utils.governor import GOVERNOR, merge_prefetch_bytes, reraise_enospc


class SortContext:
    """Header-derived context for key extraction."""

    def __init__(self, header):
        lookup = library_lookup_from_header(header.text)
        libs = sorted(set(lookup.values()) | {"unknown"})
        self._lib_ord = {lib: i for i, lib in enumerate(libs)}
        self._rg_to_ord = {rg: self._lib_ord[lib] for rg, lib in lookup.items()}

    def library_ordinal(self, rec: RawRecord) -> int:
        rg = rec.get_str(b"RG")
        return self._rg_to_ord.get(rg, self._lib_ord["unknown"])


def _mi_key(rec: RawRecord) -> tuple:
    mi = rec.get_str(b"MI")
    if mi is None:
        return (0, 0)
    base, _, suffix = mi.partition("/")
    try:
        value = int(base)
    except ValueError:
        value = 0
    return (value, 0 if suffix == "A" else 1)


def header_tags_for_order(order: str, subsort: str = "natural"):
    """(SO, GO, SS) @HD values of each order's output (keys.rs:205-241)."""
    if order == "coordinate":
        return "coordinate", None, None
    if order == "queryname":
        # the SAM spec's sub-sort keywords: natural / lexicographical
        spelled = "lexicographical" if subsort == "lex" else subsort
        return "queryname", None, f"queryname:{spelled}"
    return "unsorted", "query", "unsorted:template-coordinate"


# Target uncompressed bytes per spill frame: bounds merge-phase memory to
# O(runs * frame size) instead of O(total), mirroring the reference's
# block-framed spill streams (zspill_stream.rs).
_FRAME_BYTES = 4 << 20


def _pressure_spill_floor(max_bytes: int) -> int:
    """The smallest pool worth spilling early under memory pressure: an
    eighth of the budget, at least 4 MiB (tiny runs would blow up the
    merge's fan-in)."""
    return max(max_bytes // 8, 4 << 20)


class NativeExternalSorter:
    """Phase-1 pools of record batches spilled to sorted runs at the byte
    budget, phase-2 k-way merge (or one in-memory sort when nothing
    spilled). Ties keep ingest order, so the output is deterministic and
    the same for any ``spill_workers``."""

    _GATHER_CHUNK = 8 << 20  # target bytes per emitted wire blob

    def __init__(self, max_bytes: int = 256 << 20, tmp_dir=None,
                 max_records: int = None, spill_workers: int = 0):
        self._lib = get_lib()
        self.max_bytes = max_bytes
        self.max_records = max_records
        self._tmp_dir_arg = tmp_dir
        self._tmp_dir = None
        self._own_tmp_dir = False
        self._disk_token = None
        self._reset_pools()
        self._run_paths = []
        self.n_records = 0
        # in-flight spills are bounded by the worker count, so memory stays
        # about (1 + workers) * max_bytes
        self._spill_workers = max(int(spill_workers), 0)
        self._executor = None
        self._futures = []

    def _reset_pools(self):
        self._keys = bytearray()
        self._recs = bytearray()
        # span chunks: (koff i64, klen i32, roff i64, rlen i32) absolute
        self._chunks = []
        self._chunk_records = 0
        self._chunk_bytes = 0

    @property
    def n_runs(self) -> int:
        """Spill runs written so far."""
        return len(self._run_paths)

    # ------------------------------------------------------------------ add

    def add_record_batch(self, batch, batch_keys_fn):
        """Append one decoded RecordBatch: its keys (``batch_keys_fn``: a
        blob with off/len spans) and its contiguous block_size-prefixed
        record region, one memcpy each; spill at the budget."""
        if batch.n == 0:
            return
        keys_blob, key_off, key_len = batch_keys_fn(batch)
        base = int(batch.rec_off[0])
        wire = batch.buf[base:int(batch.data_end[-1])]
        base_k = len(self._keys)
        self._keys += keys_blob
        base_r = len(self._recs)
        # memoryview: numpy slices append through the buffer protocol (a
        # plain += would dispatch to ndarray broadcasting)
        self._recs += memoryview(wire)
        self._chunks.append((
            key_off.astype(np.int64) + base_k,
            np.asarray(key_len, dtype=np.int32),
            batch.rec_off - base + base_r,
            (batch.data_end - batch.rec_off).astype(np.int32)))
        n = batch.n
        self.n_records += n
        self._chunk_records += n
        self._chunk_bytes += len(keys_blob) + len(wire) + 32 * n
        if self._chunk_bytes >= self.max_bytes or (
                self.max_records is not None
                and self._chunk_records >= self.max_records):
            self._spill()
        elif GOVERNOR.state != "ok" and self._chunk_bytes \
                >= _pressure_spill_floor(self.max_bytes):
            # soft pressure: move the pool out of memory early
            self._spill()

    def ingest_batches(self, batches, batch_keys_fn, on_batch=None):
        """Phase-1 ingest from any RecordBatch iterable: a file reader or a
        fused-chain channel (``pipeline_chain.ChannelBatchReader``), keyed
        and pooled as they arrive (with spill workers, spills overlap the
        producer). ``on_batch(n)`` is called per batch (progress)."""
        for b in batches:
            self.add_record_batch(b, batch_keys_fn)
            if on_batch is not None:
                on_batch(b.n)

    # ---------------------------------------------------------------- phases

    def _spans(self):
        """Concatenated span arrays for the current pools."""
        chunks = self._chunks
        if not chunks:
            z64 = np.zeros(0, np.int64)
            z32 = np.zeros(0, np.int32)
            return z64, z32, z64, z32
        return tuple(np.ascontiguousarray(np.concatenate([c[k] for c in
                                                          chunks]))
                     for k in range(4))

    def _sort_perm(self, keys, koff, klen):
        n = len(klen)
        perm = np.empty(n, dtype=np.int64)
        self._lib.fgumi_sort_spans(keys.ctypes.data, koff.ctypes.data,
                                   klen.ctypes.data, n, perm.ctypes.data)
        return perm

    def _build_run(self, path, keys_b, recs_b, spans):
        """Sort and write one frozen pool to ``path`` (on a spill worker or
        inline; touches no state of the sorter)."""
        from ..observe.metrics import METRICS
        from ..observe.trace import span
        from ..utils import faults

        n = len(spans[1])
        METRICS.inc("sort.spills")
        METRICS.inc("sort.spill_records", n)
        t0 = time.monotonic()
        with span("sort.spill", records=n):
            try:
                faults.fire("sort.spill")
            except OSError as e:
                reraise_enospc(e, "sort.spill", path=self._tmp_dir)
                raise
            self._write_run(path, keys_b, recs_b, spans)
        METRICS.observe("sort.spill_s", time.monotonic() - t0)

    def _write_run(self, path, keys_b, recs_b, spans):
        koff, klen, roff, rlen = spans
        keys = np.frombuffer(keys_b, dtype=np.uint8)
        recs = np.frombuffer(recs_b, dtype=np.uint8)
        perm = self._sort_perm(keys, koff, klen)
        rc = self._lib.fgumi_write_run(
            path.encode(), keys.ctypes.data, koff.ctypes.data,
            klen.ctypes.data, recs.ctypes.data, roff.ctypes.data,
            rlen.ctypes.data, perm.ctypes.data, len(perm), _FRAME_BYTES)
        if rc != 0:
            err = -int(rc)
            e = OSError(err, f"spill write failed: {os.strerror(err)}",
                        path) if 0 < err < 256 \
                else OSError(f"spill write failed: {path}")
            # a full disk is the clean-failure contract (exit 4; close()
            # removes the runs)
            reraise_enospc(e, "sort.spill", path=self._tmp_dir)
            raise e

    def _spill(self):
        if self._chunk_records == 0:
            return
        if self._tmp_dir is None:
            if self._tmp_dir_arg is not None:
                self._tmp_dir = self._tmp_dir_arg
            else:
                self._tmp_dir = tempfile.mkdtemp(prefix="fgumi_sort_")
                self._own_tmp_dir = True
            self._disk_token = GOVERNOR.watch_path("spill", self._tmp_dir)
        # a hard watermark stops the sort before it writes another run
        GOVERNOR.check_hard()
        spans = self._spans()
        keys_b, recs_b = self._keys, self._recs
        fd, path = tempfile.mkstemp(dir=self._tmp_dir, suffix=".run")
        os.close(fd)
        self._run_paths.append(path)  # the slot is fixed: ingest order
        self._reset_pools()
        if not self._spill_workers:
            self._build_run(path, keys_b, recs_b, spans)
            return
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=self._spill_workers,
                thread_name_prefix="fgumi-spill")
        # every worker busy: wait for the oldest spill first
        while len(self._futures) >= self._spill_workers:
            self._futures.pop(0).result()
        # the worker records into the submitting command's telemetry scope
        self._futures.append(self._executor.submit(
            contextvars.copy_context().run, self._build_run, path, keys_b,
            recs_b, spans))

    def _drain_spills(self):
        """Finish every in-flight spill (the first error raises)."""
        while self._futures:
            self._futures.pop(0).result()

    def iter_sorted_wire(self):
        """Sorted output as writable uint8 wire chunks of about
        ``_GATHER_CHUNK`` bytes (block_size-prefixed records)."""
        for arr, _ in self.sorted_chunks_with_lens():
            yield arr

    def sorted_chunks_with_lens(self):
        """(writable uint8 wire chunk, int32 wire length of each record in
        it) in sorted order (the index needs the record boundaries)."""
        if not self._run_paths:
            yield from self._in_memory_chunks()
            return
        self._spill()
        self._drain_spills()
        paths = b"\n".join(p.encode() for p in self._run_paths)
        n_runs = len(self._run_paths)
        # the merge prefetches frames with two or more workers (with one,
        # the merge thread takes most frames back and only pays for the
        # hand-off: the reference's measured rule), holding at most the
        # prefetch budget's frames beyond each run's current one
        frames = (merge_prefetch_bytes() // _FRAME_BYTES
                  if self._spill_workers >= 2 and n_runs > 1 else 0)
        h = self._lib.fgumi_merge_open2(
            paths, len(paths), n_runs,
            min(self._spill_workers, n_runs) if frames else 0, frames)
        if not h:
            raise OSError("spill merge open failed")
        import ctypes

        try:
            cap = self._GATHER_CHUNK
            max_recs = max(cap // 64, 1024)
            out = np.empty(cap, dtype=np.uint8)
            lens = np.empty(max_recs, dtype=np.int32)
            n_out = ctypes.c_long(0)
            from ..observe.metrics import METRICS

            while True:
                t0 = time.monotonic()
                n_bytes = self._lib.fgumi_merge_next(
                    h, out.ctypes.data, cap, lens.ctypes.data, max_recs,
                    ctypes.addressof(n_out))
                METRICS.observe("sort.merge_frame_s", time.monotonic() - t0)
                if n_bytes < 0:
                    raise OSError("corrupt spill run during merge")
                if n_bytes == 0:
                    break
                yield out[:n_bytes].copy(), lens[:n_out.value].copy()
        finally:
            self._lib.fgumi_merge_close(h)

    def _in_memory_chunks(self):
        koff, klen, roff, rlen = self._spans()
        keys = np.frombuffer(self._keys, dtype=np.uint8)
        perm = self._sort_perm(keys, koff, klen)
        recs = np.frombuffer(self._recs, dtype=np.uint8)
        n = len(perm)
        if n == 0:
            return
        # chunk boundaries in one vectorized pass: first index where the
        # cumulative size clears each successive _GATHER_CHUNK multiple
        lens_sorted = rlen[perm]
        csum = np.cumsum(lens_sorted, dtype=np.int64)
        targets = np.arange(self._GATHER_CHUNK, int(csum[-1]),
                            self._GATHER_CHUNK, dtype=np.int64)
        bounds = np.unique(np.concatenate((
            [0], np.searchsorted(csum, targets, side="left") + 1, [n])))
        for i, j in zip(bounds[:-1], bounds[1:]):
            i, j = int(i), int(j)
            out = np.empty(int(csum[j - 1] - (csum[i - 1] if i else 0)),
                           dtype=np.uint8)
            sub = np.ascontiguousarray(perm[i:j])
            self._lib.fgumi_gather_spans(
                recs.ctypes.data, roff.ctypes.data, rlen.ctypes.data,
                sub.ctypes.data, j - i, out.ctypes.data)
            yield out, lens_sorted[i:j]

    def close(self):
        GOVERNOR.unwatch_path(self._disk_token)
        self._disk_token = None
        try:
            self._drain_spills()
        except Exception:  # noqa: BLE001 - close() must still clean up
            pass
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        for path in self._run_paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._run_paths = []
        self._reset_pools()
        if self._own_tmp_dir and self._tmp_dir is not None:
            try:
                os.rmdir(self._tmp_dir)
            except OSError:
                pass
            self._tmp_dir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
