"""Batched BAM reading: struct-of-arrays record batches over chunk buffers.

Decompressed bytes (io/bgzf.py: zlib, BGZF blocks inflated in parallel,
the file read ahead by io/prefetch.py) are scanned for record boundaries and
field-decoded by the native library (native/batch.py), so the Python layer
holds numpy arrays per batch instead of objects per record.
"""

import numpy as np

from ..native import batch as nb
from .bam import BamHeader, RawRecord
from .bgzf import BgzfReader
from .prefetch import PrefetchFile, prefetch_enabled

# Smallest possible BAM record on the wire: 4-byte block_size + 32 fixed +
# 1-byte name (NUL only); bounds the boundary-array allocation.
_MIN_RECORD_WIRE = 37


class RecordBatch:
    """A contiguous run of BAM records decoded struct-of-arrays.

    ``buf`` is a writable uint8 view of the chunk (overlap correction
    mutates seq/qual bytes in place). All offset arrays index into ``buf``.
    """

    __slots__ = ("buf", "rec_off", "n", "ref_id", "pos", "mapq", "flag",
                 "l_seq", "n_cigar", "l_read_name", "next_ref_id", "next_pos",
                 "tlen", "data_off", "data_end", "cigar_off", "seq_off",
                 "qual_off", "aux_off", "_tag_locs")

    def __init__(self, buf: np.ndarray, rec_off: np.ndarray):
        self.buf = buf
        self.rec_off = rec_off
        self.n = len(rec_off)
        for k, v in nb.decode_fields(self.buf, rec_off).items():
            setattr(self, k, v)
        self.cigar_off = self.data_off + 32 + self.l_read_name
        self.seq_off = self.cigar_off + 4 * self.n_cigar.astype(np.int64)
        self.qual_off = self.seq_off + (self.l_seq + 1) // 2
        self.aux_off = self.qual_off + self.l_seq
        self._tag_locs = {}

    def prefetch_tags(self, tags):
        """Seed the per-batch tag cache with ONE native aux scan for every
        not-yet-cached tag."""
        need = [t for t in tags if t not in self._tag_locs]
        if not need:
            return
        bad = [t for t in need if len(t) != 2]
        if bad:
            raise ValueError(f"SAM tags must be exactly 2 bytes: {bad!r}")
        vo, vl, vt = nb.scan_tags(self.buf, self.aux_off, self.data_end,
                                  need)
        for j, t in enumerate(need):
            self._tag_locs[t] = (np.ascontiguousarray(vo[:, j]),
                                 np.ascontiguousarray(vl[:, j]),
                                 np.ascontiguousarray(vt[:, j]))

    def tag_locs(self, tag: bytes):
        """(val_off int64[n], val_len int32[n], val_type uint8[n]) for one
        tag; val_off -1 where absent. Cached per batch."""
        got = self._tag_locs.get(tag)
        if got is None:
            self.prefetch_tags([tag])
            got = self._tag_locs[tag]
        return got

    def tag_locs_str(self, tag: bytes):
        """tag_locs with non-string-typed (not Z/H) tags masked to absent,
        matching RawRecord.get_str's type gate. Cached per batch."""
        got = self._tag_locs.get((tag, "str"))
        if got is None:
            vo, vl, vt = self.tag_locs(tag)
            ok = (vt == ord("Z")) | (vt == ord("H"))
            got = (np.where(ok, vo, -1), vl, vt)
            self._tag_locs[(tag, "str")] = got
        return got

    def tag_bytes(self, tag: bytes, i: int):
        """One record's tag value bytes (Z/H string, no NUL), or None."""
        vo, vl, _ = self.tag_locs(tag)
        if vo[i] < 0:
            return None
        return self.buf[vo[i]: vo[i] + vl[i]].tobytes()

    def name(self, i: int) -> bytes:
        off = self.data_off[i] + 32
        return self.buf[off: off + self.l_read_name[i] - 1].tobytes()

    def raw_record(self, i: int) -> RawRecord:
        """One record as a RawRecord (slow-path interop)."""
        return RawRecord(self.buf[self.data_off[i]: self.data_end[i]].tobytes())

    def raw_records(self, indices) -> list:
        return [self.raw_record(int(i)) for i in indices]


class BatchedRecordReader:
    """A :class:`~.bam.BamReader` look-alike over :class:`BamBatchReader`:
    it yields RawRecords, but inflates and finds record boundaries a batch
    at a time (zipper's per-template engine reads through it, as the
    reference's does)."""

    def __init__(self, path_or_obj, target_bytes: int = 8 << 20):
        self._r = BamBatchReader(path_or_obj, target_bytes=target_bytes)
        self.header = self._r.header

    def __iter__(self):
        for batch in self._r:
            for i in range(batch.n):
                yield batch.raw_record(i)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _BatchAssembler:
    """Accumulate → boundary-scan → tail-carry loop: ``read_chunk()`` returns
    the next decoded uint8 array (empty at end of stream); iteration yields
    RecordBatch objects of about ``target_bytes`` payload."""

    def __init__(self, read_chunk, target_bytes: int):
        self._read_chunk = read_chunk
        # a non-positive target would yield nothing: clamp to one chunk
        self._target = max(int(target_bytes), 1)
        self._parts = []
        self._parts_len = 0
        self._eof = False

    def _fill(self):
        while self._parts_len < self._target and not self._eof:
            arr = self._read_chunk()
            if not len(arr):
                self._eof = True
                break
            self._parts.append(arr)
            self._parts_len += len(arr)

    def __iter__(self):
        while True:
            self._fill()
            if not self._parts_len:
                return
            buf = (self._parts[0] if len(self._parts) == 1
                   else np.concatenate(self._parts))
            max_records = len(buf) // _MIN_RECORD_WIRE + 1
            offsets, scanned = nb.find_boundaries(buf, max_records)
            if len(offsets) == 0:
                if self._eof:
                    raise EOFError("truncated BAM record at end of stream")
                # a single record larger than the accumulated bytes: grow
                self._target *= 2
                self._parts = [buf]
                self._parts_len = len(buf)
                continue
            # copy the (at most one partial record) tail so the next batch
            # does not pin this batch's buffer
            tail = buf[scanned:].copy()
            self._parts = [tail] if len(tail) else []
            self._parts_len = len(tail)
            yield RecordBatch(buf[:scanned], offsets.copy())


class BamBatchReader:
    """Yields RecordBatch objects of about ``target_bytes`` decompressed
    payload. The file is read ahead on a thread (``io.prefetch``, unless
    ``FGUMI_TPU_NO_PREFETCH``) and its BGZF blocks inflate in parallel."""

    def __init__(self, path: str, target_bytes: int = 16 << 20):
        fileobj = open(path, "rb")
        if prefetch_enabled():
            fileobj = PrefetchFile(fileobj)
        self._r = BgzfReader(fileobj, owns_fileobj=True, name=path)
        try:
            self.header = BamHeader.decode_from(self._r.read, path)
        except BaseException:
            # a corrupt header still stops the read-ahead thread and
            # closes the file
            self._r.close()
            raise
        self._asm = _BatchAssembler(self._r.read_decoded, target_bytes)

    def __iter__(self):
        return iter(self._asm)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
