"""Packed binary sort keys: memcmp order == semantic order.

The reference packs sort keys into fixed-width integers so an unstable radix
sort becomes total (crates/fgumi-sort/src/keys.rs, radix.rs:35). Here keys
are byte strings whose lexicographic (memcmp) comparison reproduces the
order, all big-endian; spill runs carry the key verbatim, so the merge
never re-extracts:

- coordinate: tid(4) pos+1(4); an unmapped tid (< 0) keys as
  ``_TID_UNMAPPED``, above any real one, so those records sort last;
- natural queryname: per name element, a digit run as 0x01 + u8 digit
  count + the digits without leading zeros (fewer digits = smaller number;
  equal counts compare as numbers), a text run as 0x02 + text + 0x00; then
  0x00 and the rank (primaries first, R1 before R2, then the flag);
- lexicographic queryname: the raw name + 0x00 + the rank;
- template-coordinate: tid1(4) tid2(4) pos1(4) pos2(4) !neg1 !neg2 lib(2)
  mi-value(8) mi-sub name 0x00 is_upper, the TemplateKey field order
  (fgumi-sort/src/inline.rs:620-694).

Two routes with the same bytes: :func:`make_key_bytes_fn` (per record, the
plain version: ``sort --verify`` and the tests use it) and
:func:`make_batch_keys_fn` (a whole record batch at once, natively where
the key has a native export: the sort's ingest).
"""

import re
import struct

import numpy as np

from ..core.overlap import parse_soft_clips_and_ref_len
from ..core.template import unclipped_5prime
from ..io.bam import (FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_REVERSE, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, RawRecord)
from ..native import batch as nb
from .external import SortContext, _mi_key

_DIGITS = re.compile(rb"(\d+)")

# Bias keeping template-coordinate positions non-negative in u32: unclipped
# starts can go below zero on heavily clipped leading alignments.
_POS_BIAS = 0x4000_0000
# above any real reference id (tids are int32 < 2^31)
_TID_UNMAPPED = 1 << 31
_POS_SENTINEL = 0x7FFF_FFFF

_ORDERS = ("coordinate", "queryname", "template-coordinate")


def coordinate_key_bytes(rec: RawRecord) -> bytes:
    """samtools coordinate order: mapped by (tid, pos), unmapped (tid < 0)
    last."""
    tid = rec.ref_id
    return struct.pack(">II", _TID_UNMAPPED if tid < 0 else tid, rec.pos + 1)


def encode_natural_name(name: bytes) -> bytes:
    """Byte-comparable natural (digit-aware) name encoding."""
    out = bytearray()
    for part in _DIGITS.split(name):
        if not part:
            continue
        if part.isdigit():
            sig = part.lstrip(b"0")
            out += b"\x01" + bytes([len(sig)]) + sig
        else:
            out += b"\x02" + part + b"\x00"
    return bytes(out)


def _rank_bytes(flag: int) -> bytes:
    """Order within one name: primaries first, R1 before R2, then flag."""
    sec = 1 if flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY) else 0
    r12 = 0 if not flag & FLAG_PAIRED else (1 if flag & FLAG_FIRST else 2)
    return struct.pack(">BBH", sec, r12, flag)


def queryname_key_bytes(rec: RawRecord, lexicographic: bool = False) -> bytes:
    name = rec.name
    enc = name if lexicographic else encode_natural_name(name)
    return enc + b"\x00" + _rank_bytes(rec.flag)


def _own_end(rec: RawRecord, flag: int):
    if flag & FLAG_UNMAPPED:
        return (_TID_UNMAPPED, _POS_SENTINEL, False)
    return (rec.ref_id, unclipped_5prime(rec) + 1, bool(flag & FLAG_REVERSE))


def _mate_end(rec: RawRecord, flag: int):
    if not flag & FLAG_PAIRED or flag & FLAG_MATE_UNMAPPED \
            or rec.next_ref_id < 0:
        return (_TID_UNMAPPED, _POS_SENTINEL, False)
    mate_rev = bool(flag & FLAG_MATE_REVERSE)
    mate_pos = rec.next_pos + 1  # 1-based
    mc = rec.get_str(b"MC")
    leading = ref_len = trailing = 0
    if mc is not None:
        parsed = parse_soft_clips_and_ref_len(mc)
        if parsed is not None:
            leading, ref_len, trailing = parsed
    if mate_rev:
        pos = mate_pos - 1 + max(ref_len, 1) - 1 + trailing + 1
    else:
        pos = mate_pos - leading
    return (rec.next_ref_id, pos, mate_rev)


def template_coordinate_key_bytes(rec: RawRecord, library_ord: int,
                                  mi: tuple) -> bytes:
    """TemplateKey analog: earlier end first; reverse strand sorts before
    forward (inverted flag); the lower-end record sorts before its mate."""
    flag = rec.flag
    own = _own_end(rec, flag)
    mate = _mate_end(rec, flag)
    if own <= mate:
        lo, hi, is_upper = own, mate, 0
    else:
        lo, hi, is_upper = mate, own, 1
    tid1, pos1, neg1 = lo
    tid2, pos2, neg2 = hi
    return (struct.pack(">IIII", tid1, tid2, pos1 + _POS_BIAS,
                        pos2 + _POS_BIAS)
            + bytes([0 if neg1 else 1, 0 if neg2 else 1])
            + struct.pack(">HQB", library_ord,
                          max(0, min(mi[0], 0xFFFF_FFFF_FFFF_FFFF)), mi[1])
            # raw name bytes: template-coordinate name order only needs to be
            # a deterministic grouping (the reference hashes names here,
            # inline.rs TemplateKey name_hash_upper)
            + rec.name + b"\x00" + bytes([is_upper]))


def _check_order(order: str):
    if order not in _ORDERS:
        raise ValueError(f"unknown sort order: {order}")


def make_key_bytes_fn(order: str, header, subsort: str = "natural"):
    """Per-record packed-key function (the plain version)."""
    _check_order(order)
    if order == "coordinate":
        return coordinate_key_bytes
    if order == "queryname":
        lex = subsort == "lex"
        return lambda rec: queryname_key_bytes(rec, lexicographic=lex)
    ctx = SortContext(header)
    return lambda rec: template_coordinate_key_bytes(
        rec, ctx.library_ordinal(rec), _mi_key(rec))


def _coordinate_keys(batch):
    arr = np.empty((batch.n, 2), dtype=">u4")
    tid = batch.ref_id.astype(np.int64)
    arr[:, 0] = np.where(tid < 0, _TID_UNMAPPED, tid)
    # pos -1 (unplaced) keys as 0, as the per-record key's u32 does
    arr[:, 1] = batch.pos.astype(np.int64) + 1
    off = np.arange(batch.n, dtype=np.int64) * 8
    return arr.tobytes(), off, np.full(batch.n, 8, dtype=np.int32)


def _lex_name_keys(batch):
    buf = batch.buf
    name_off = batch.data_off + 32
    name_len = batch.l_read_name - 1
    parts = [buf[name_off[i]:name_off[i] + name_len[i]].tobytes()
             + b"\x00" + _rank_bytes(int(batch.flag[i]))
             for i in range(batch.n)]
    lens = np.array([len(p) for p in parts], dtype=np.int32)
    off = np.zeros(batch.n, dtype=np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return b"".join(parts), off, lens


def _natural_name_keys(batch):
    out, out_off, out_len = nb.natural_name_keys(batch)
    return out.tobytes(), out_off, out_len


def make_batch_keys_fn(order: str, header, subsort: str = "natural"):
    """Whole-RecordBatch packed-key extraction: fn(batch) -> (blob, off, len).

    Byte-for-byte the keys of :func:`make_key_bytes_fn`, one pass per
    batch (native for the natural-queryname and template-coordinate keys);
    the keys stay in one blob with int64 offset / int32 length span tables
    (record i's key is blob[off[i]:off[i]+len[i]]; spans may leave gaps),
    so the native sorter ingests them without per-record bytes objects.
    """
    _check_order(order)
    if order == "coordinate":
        return _coordinate_keys
    if order == "queryname":
        return _lex_name_keys if subsort == "lex" else _natural_name_keys
    ctx = SortContext(header)
    unknown_ord = ctx._lib_ord["unknown"]

    def tc_keys(batch):
        # one fused aux scan for everything this key fn + the native key
        # extractor read
        batch.prefetch_tags([b"RG", b"MC", b"MI"])
        # vectorized RG -> library ordinal: resolve each distinct RG value
        # once (hash-deduplicated, byte-verified)
        rg_off, rg_len, _ = batch.tag_locs_str(b"RG")
        lib_ord = np.full(batch.n, unknown_ord, dtype=np.int32)
        present = rg_off >= 0
        if present.any():
            hashes = nb.hash_ranges(batch.buf, rg_off, rg_len)
            uniq, first_idx, inv = np.unique(
                hashes, return_index=True, return_inverse=True)
            # hash-collision guard: every row must byte-match its
            # representative, else exact per-record lookup
            reps = first_idx[inv]
            eq = nb.ranges_equal(batch.buf, rg_off, rg_len, rg_off[reps],
                                 rg_len[reps])
            if eq[present].all():
                ords = np.empty(len(uniq), dtype=np.int32)
                for u, fi in enumerate(first_idx):
                    if rg_off[fi] < 0:
                        ords[u] = unknown_ord
                        continue
                    rg = batch.buf[rg_off[fi]:rg_off[fi] + rg_len[fi]] \
                        .tobytes().decode(errors="replace")
                    ords[u] = ctx._rg_to_ord.get(rg, unknown_ord)
                lib_ord = ords[inv]
                lib_ord[~present] = unknown_ord
            else:
                for i in np.nonzero(present)[0]:
                    rg = batch.buf[rg_off[i]:rg_off[i] + rg_len[i]] \
                        .tobytes().decode(errors="replace")
                    lib_ord[i] = ctx._rg_to_ord.get(rg, unknown_ord)
        out, out_off = nb.template_coord_keys(batch, lib_ord)
        return (out.tobytes(), out_off[:-1],
                np.diff(out_off).astype(np.int32))

    return tc_keys


def iter_keyed_records(path_or_obj, batch_keys_fn):
    """(packed key bytes, record wire bytes) per record, the keys extracted
    a batch at a time by ``batch_keys_fn`` (:func:`make_batch_keys_fn`):
    the k-way merge's input stream (``merge``)."""
    from ..io.batch_reader import BamBatchReader

    with BamBatchReader(path_or_obj) as br:
        for batch in br:
            blob, koff, klen = batch_keys_fn(batch)
            buf = batch.buf
            do, de = batch.data_off, batch.data_end
            for i in range(batch.n):
                yield blob[koff[i]:koff[i] + klen[i]], bytes(buf[do[i]:de[i]])
