"""Numpy-facing wrappers for the native batch record layer.

Each call hands whole numpy arrays to C++ (``fgumi_native.cc``), so Python
cost is per batch, not per record. Pointers cross as raw addresses
(``ndarray.ctypes.data``); every converted operand stays referenced in the
wrapper's frame until the foreign call returns.
"""

import numpy as np

from ..utils import faults
from . import get_lib


def _addr(arr: np.ndarray) -> int:
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("native operand must be C-contiguous")
    return arr.ctypes.data


def find_boundaries(buf: np.ndarray, max_records: int):
    """(offsets int64[n], scanned): record starts in decompressed BAM bytes
    and the offset just past the last complete record. The entry of every
    record batch, and the ``native.batch`` fault point."""
    faults.fire("native.batch")
    lib = get_lib()
    offsets = np.empty(max_records, dtype=np.int64)
    scanned = np.zeros(1, dtype=np.int64)
    n = lib.fgumi_find_record_boundaries(_addr(buf), len(buf),
                                         _addr(offsets), max_records,
                                         _addr(scanned))
    return offsets[:n], int(scanned[0])


def decode_fields(buf: np.ndarray, rec_off: np.ndarray) -> dict:
    """Struct-of-arrays fixed-field decode (SAM spec §4.2 layout)."""
    lib = get_lib()
    n = len(rec_off)
    rec_off = np.ascontiguousarray(rec_off, np.int64)
    i32 = {k: np.empty(n, dtype=np.int32)
           for k in ("ref_id", "pos", "mapq", "flag", "l_seq", "n_cigar",
                     "l_read_name", "next_ref_id", "next_pos", "tlen")}
    data_off = np.empty(n, dtype=np.int64)
    data_end = np.empty(n, dtype=np.int64)
    lib.fgumi_decode_fields(
        _addr(buf), _addr(rec_off), n,
        _addr(i32["ref_id"]), _addr(i32["pos"]), _addr(i32["mapq"]),
        _addr(i32["flag"]), _addr(i32["l_seq"]), _addr(i32["n_cigar"]),
        _addr(i32["l_read_name"]), _addr(i32["next_ref_id"]),
        _addr(i32["next_pos"]), _addr(i32["tlen"]), _addr(data_off),
        _addr(data_end))
    i32["data_off"] = data_off
    i32["data_end"] = data_end
    return i32


def scan_tags(buf: np.ndarray, aux_off: np.ndarray, aux_end: np.ndarray,
              tags: list):
    """Per-record aux-tag locations for k tags: (val_off int64[n, k],
    val_len int32[n, k], val_type uint8[n, k]); val_off -1 where absent."""
    lib = get_lib()
    n = len(aux_off)
    k = len(tags)
    aux_off = np.ascontiguousarray(aux_off, np.int64)
    aux_end = np.ascontiguousarray(aux_end, np.int64)
    tag_bytes = np.frombuffer(b"".join(tags), dtype=np.uint8)
    val_off = np.empty((n, k), dtype=np.int64)
    val_len = np.empty((n, k), dtype=np.int32)
    val_type = np.empty((n, k), dtype=np.uint8)
    lib.fgumi_scan_tags(_addr(buf), _addr(aux_off), _addr(aux_end), n,
                        _addr(tag_bytes), k, _addr(val_off), _addr(val_len),
                        _addr(val_type))
    return val_off, val_len, val_type


def group_starts(buf: np.ndarray, off: np.ndarray, length: np.ndarray):
    """Indices where a run of equal byte ranges starts; raises if a range
    is missing (off < 0)."""
    lib = get_lib()
    n = len(off)
    off = np.ascontiguousarray(off, np.int64)
    length = np.ascontiguousarray(length, np.int32)
    starts = np.empty(n, dtype=np.int64)
    g = lib.fgumi_group_starts(_addr(buf), _addr(off), _addr(length), n,
                               _addr(starts))
    if g < 0:
        raise ValueError(f"record {-g - 1} missing grouping tag; run `group` "
                         "first")
    return starts[:g]


def pack_reads(buf: np.ndarray, seq_off: np.ndarray, qual_off: np.ndarray,
               l_seq: np.ndarray, reverse: np.ndarray, clip: np.ndarray,
               min_q: int, stride: int, mode: int = 0):
    """Batch SourceRead conversion into (n, stride) code/qual rows.

    Returns (codes uint8[n, stride], quals uint8[n, stride], final_len
    int32[n]); final_len -1 marks rejected reads (empty / all-0xFF quals).
    ``mode`` bit0 keeps all-0xFF reads, bit1 keeps trailing Ns (the CODEC
    conversion)."""
    lib = get_lib()
    n = len(seq_off)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    qual_off = np.ascontiguousarray(qual_off, np.int64)
    l_seq = np.ascontiguousarray(l_seq, np.int32)
    reverse = np.ascontiguousarray(reverse, np.uint8)
    clip = np.ascontiguousarray(clip, np.int32)
    codes = np.empty((n, stride), dtype=np.uint8)
    quals = np.empty((n, stride), dtype=np.uint8)
    final_len = np.empty(n, dtype=np.int32)
    lib.fgumi_pack_reads(_addr(buf), _addr(seq_off), _addr(qual_off),
                         _addr(l_seq), _addr(reverse), _addr(clip), n,
                         int(min_q), int(stride), int(mode), _addr(codes),
                         _addr(quals), _addr(final_len))
    return codes, quals, final_len


def mate_clips(buf: np.ndarray, cigar_off: np.ndarray, n_cigar: np.ndarray,
               flag: np.ndarray, ref_id: np.ndarray, pos: np.ndarray,
               next_ref_id: np.ndarray, next_pos: np.ndarray,
               tlen: np.ndarray, mc_off: np.ndarray, mc_len: np.ndarray):
    """Batch num_bases_extending_past_mate (MC-tag mate clip) -> int32[n]."""
    lib = get_lib()
    n = len(cigar_off)
    cigar_off = np.ascontiguousarray(cigar_off, np.int64)
    mc_off = np.ascontiguousarray(mc_off, np.int64)
    n_cigar, flag, ref_id, pos, next_ref_id, next_pos, tlen, mc_len = (
        np.ascontiguousarray(a, np.int32)
        for a in (n_cigar, flag, ref_id, pos, next_ref_id, next_pos, tlen,
                  mc_len))
    clip = np.empty(n, dtype=np.int32)
    lib.fgumi_mate_clips(
        _addr(buf), _addr(cigar_off), _addr(n_cigar), _addr(flag),
        _addr(ref_id), _addr(pos), _addr(next_ref_id), _addr(next_pos),
        _addr(tlen), _addr(mc_off), _addr(mc_len), n, _addr(clip))
    return clip


def ranges_equal(buf: np.ndarray, off_a, len_a, off_b, len_b):
    """uint8[n]: byte range a equals byte range b (both present)."""
    lib = get_lib()
    n = len(off_a)
    off_a = np.ascontiguousarray(off_a, np.int64)
    off_b = np.ascontiguousarray(off_b, np.int64)
    len_a = np.ascontiguousarray(len_a, np.int32)
    len_b = np.ascontiguousarray(len_b, np.int32)
    out = np.empty(n, dtype=np.uint8)
    lib.fgumi_ranges_equal(_addr(buf), _addr(off_a), _addr(len_a),
                           _addr(off_b), _addr(len_b), n, _addr(out))
    return out


def hash_ranges(buf: np.ndarray, off, length):
    """FNV-1a 64-bit hash per byte range (off < 0 -> 0)."""
    lib = get_lib()
    n = len(off)
    off = np.ascontiguousarray(off, np.int64)
    length = np.ascontiguousarray(length, np.int32)
    out = np.empty(n, dtype=np.uint64)
    lib.fgumi_hash_ranges(_addr(buf), _addr(off), _addr(length), n,
                          _addr(out))
    return out


def rx_unanimous(buf: np.ndarray, off, length, starts):
    """Per-segment RX unanimity: (out_off int64[J], out_len int32[J]);
    out_off -1 = no tag in the segment, -2 = needs the Python consensus,
    >= 0 = the verbatim unanimous value's buffer range."""
    lib = get_lib()
    J = len(starts) - 1
    off = np.ascontiguousarray(off, np.int64)
    length = np.ascontiguousarray(length, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    out_off = np.empty(J, dtype=np.int64)
    out_len = np.empty(J, dtype=np.int32)
    lib.fgumi_rx_unanimous(_addr(buf), _addr(off), _addr(length),
                           _addr(starts), J, _addr(out_off), _addr(out_len))
    return out_off, out_len


def overlap_correct_pairs(buf: np.ndarray, r1_off: np.ndarray,
                          r2_off: np.ndarray, agreement: int,
                          disagreement: int) -> np.ndarray:
    """In-place R1/R2 overlap correction on a writable buffer. Returns
    int64[4] (overlapping, agreeing, disagreeing, corrected)."""
    lib = get_lib()
    if not buf.flags["WRITEABLE"]:
        raise ValueError("overlap correction needs a writable buffer")
    r1_off = np.ascontiguousarray(r1_off, np.int64)
    r2_off = np.ascontiguousarray(r2_off, np.int64)
    stats = np.zeros(4, dtype=np.int64)
    lib.fgumi_overlap_correct_pairs(_addr(buf), _addr(r1_off), _addr(r2_off),
                                    len(r1_off), int(agreement),
                                    int(disagreement), _addr(stats))
    return stats


def build_consensus_records(code_addr, qual_addr, depth_addr, err_addr, lens,
                            flags, prefix: bytes, mi_addr, mi_len,
                            rx_addr, rx_len, rg: bytes,
                            per_base_tags: bool):
    """Serialize J consensus records into one block_size-prefixed wire blob.

    The ``*_addr`` arrays are raw element addresses (int64) into caller-owned
    arrays, which MUST stay referenced for the duration of the call; MI/RX
    values are addresses too (rx_addr 0 = absent tag). Returns (bytes,
    rec_end int64[J])."""
    lib = get_lib()
    J = len(lens)
    lens = np.ascontiguousarray(lens, np.int32)
    flags = np.ascontiguousarray(flags, np.int32)
    mi_len = np.ascontiguousarray(mi_len, np.int32)
    rx_len = np.ascontiguousarray(rx_len, np.int32)
    code_addr, qual_addr, depth_addr, err_addr, mi_addr, rx_addr = (
        np.ascontiguousarray(a, np.int64)
        for a in (code_addr, qual_addr, depth_addr, err_addr, mi_addr,
                  rx_addr))
    # exact per-record size bound (mirrors the C size computation)
    per_rec = (4 + 32 + len(prefix) + 1 + mi_len.astype(np.int64) + 1
               + (lens + 1) // 2 + lens + (3 + len(rg) + 1) + 21
               + (3 + mi_len.astype(np.int64) + 1)
               + np.where(rx_addr != 0, 3 + rx_len.astype(np.int64) + 1, 0))
    if per_base_tags:
        per_rec = per_rec + 2 * (8 + 2 * lens.astype(np.int64))
    out_cap = int(per_rec.sum())
    out = np.empty(max(out_cap, 1), dtype=np.uint8)
    rec_end = np.empty(J, dtype=np.int64)
    prefix_arr = np.frombuffer(prefix, dtype=np.uint8)
    rg_arr = np.frombuffer(rg, dtype=np.uint8)
    total = lib.fgumi_build_consensus_records(
        _addr(code_addr), _addr(qual_addr), _addr(depth_addr),
        _addr(err_addr), _addr(lens), _addr(flags), J,
        _addr(prefix_arr) if len(prefix) else 0, len(prefix), _addr(mi_addr),
        _addr(mi_len), _addr(rx_addr), _addr(rx_len),
        _addr(rg_arr) if len(rg) else 0, len(rg), int(per_base_tags),
        _addr(out), out_cap, _addr(rec_end))
    if total == -2:
        raise ValueError("read name too long (prefix + MI exceeds 254 bytes)")
    if total < 0:
        raise RuntimeError("consensus record serialization overflow")
    return out[:total].tobytes(), rec_end


def build_duplex_records(code_addr, qual_addr, err_addr, lens, flags,
                         prefix: bytes, mi_addr, mi_len,
                         a_code, a_qual, a_depth, a_err, a_len,
                         b_code, b_qual, b_depth, b_err, b_len, b_present,
                         rx_addr, rx_len, rg: bytes, per_base_tags: bool):
    """Serialize J duplex consensus records into one wire blob.

    All ``*_addr`` / strand arrays are raw element addresses (int64) into
    caller-owned arrays that MUST stay referenced for the call's duration;
    b_present 0 = BA strand absent, rx_addr 0 = no RX tag. Returns (bytes,
    rec_end int64[J])."""
    lib = get_lib()
    J = len(lens)
    lens = np.ascontiguousarray(lens, np.int32)
    flags = np.ascontiguousarray(flags, np.int32)
    mi_len = np.ascontiguousarray(mi_len, np.int32)
    a_len = np.ascontiguousarray(a_len, np.int32)
    b_len = np.ascontiguousarray(b_len, np.int32)
    b_present = np.ascontiguousarray(b_present, np.uint8)
    rx_len = np.ascontiguousarray(rx_len, np.int32)
    (code_addr, qual_addr, err_addr, mi_addr, a_code, a_qual, a_depth, a_err,
     b_code, b_qual, b_depth, b_err, rx_addr) = (
        np.ascontiguousarray(a, np.int64)
        for a in (code_addr, qual_addr, err_addr, mi_addr, a_code, a_qual,
                  a_depth, a_err, b_code, b_qual, b_depth, b_err, rx_addr))
    # per-record size bound (covers the C size computation)
    L64 = lens.astype(np.int64)
    aL64 = a_len.astype(np.int64)
    bL64 = np.where(b_present != 0, b_len, 0).astype(np.int64)
    per_rec = (4 + 32 + len(prefix) + 1 + mi_len.astype(np.int64) + 1
               + (L64 + 1) // 2 + L64
               + (3 + mi_len.astype(np.int64) + 1) + (3 + len(rg) + 1)
               + 9 * 7
               + np.where(rx_addr != 0, 3 + rx_len.astype(np.int64) + 1, 0))
    if per_base_tags:
        per_rec = per_rec + 2 * (4 + aL64) + 16 + 4 * aL64 \
            + np.where(b_present != 0, 2 * (4 + bL64) + 16 + 4 * bL64, 0)
    out_cap = int(per_rec.sum())
    out = np.empty(max(out_cap, 1), dtype=np.uint8)
    rec_end = np.empty(J, dtype=np.int64)
    prefix_arr = np.frombuffer(prefix, dtype=np.uint8)
    rg_arr = np.frombuffer(rg, dtype=np.uint8)
    total = lib.fgumi_build_duplex_records(
        _addr(code_addr), _addr(qual_addr), _addr(err_addr), _addr(lens),
        _addr(flags), J, _addr(prefix_arr) if len(prefix) else 0,
        len(prefix), _addr(mi_addr), _addr(mi_len), _addr(a_code),
        _addr(a_qual), _addr(a_depth), _addr(a_err), _addr(a_len),
        _addr(b_code), _addr(b_qual), _addr(b_depth), _addr(b_err),
        _addr(b_len), _addr(b_present), _addr(rx_addr), _addr(rx_len),
        _addr(rg_arr) if len(rg) else 0, len(rg), int(per_base_tags),
        _addr(out), out_cap, _addr(rec_end))
    if total == -2:
        raise ValueError("read name too long (prefix + MI exceeds 254 bytes)")
    if total < 0:
        raise RuntimeError("duplex record serialization overflow")
    return out[:total].tobytes(), rec_end


def segment_depth_errors(codes2d: np.ndarray, winner: np.ndarray,
                         starts: np.ndarray):
    """Per-segment depth/error counts, a (J, L) int32 pair: codes2d the
    dense (N, L) uint8 read rows, winner the (J, L) uint8 called bases,
    starts the (J+1,) row boundaries."""
    lib = get_lib()
    J, L = winner.shape
    depth = np.empty((J, L), dtype=np.int32)
    errors = np.empty((J, L), dtype=np.int32)
    codes2d = np.ascontiguousarray(codes2d, np.uint8)
    winner = np.ascontiguousarray(winner, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lib.fgumi_segment_depth_errors(_addr(codes2d), _addr(winner),
                                   _addr(starts), J, L, _addr(depth),
                                   _addr(errors))
    return depth, errors


def segment_depth_errors_ranges(codes2d: np.ndarray, winner: np.ndarray,
                                lo, hi):
    """:func:`segment_depth_errors` over explicit [lo[j], hi[j]) row
    ranges."""
    lib = get_lib()
    J, L = winner.shape
    depth = np.empty((J, L), dtype=np.int32)
    errors = np.empty((J, L), dtype=np.int32)
    codes2d = np.ascontiguousarray(codes2d, np.uint8)
    winner = np.ascontiguousarray(winner, np.uint8)
    lo = np.ascontiguousarray(lo, np.int64)
    hi = np.ascontiguousarray(hi, np.int64)
    lib.fgumi_segment_depth_errors_ranges(
        _addr(codes2d), _addr(winner), _addr(lo), _addr(hi), J, L,
        _addr(depth), _addr(errors))
    return depth, errors


def duplex_rx_fast(buf, una_off, una_len, cnt, a_seg, b_seg):
    """Duplex consensus-RX fast path: resolves every output whose
    contributing segs are unanimous (or absent) in C — single-read
    verbatim, all-equal uppercased, the b-side strand flip done on bytes.
    Returns (rx_off i64, rx_len i32, blob u8, fb_idx i64): outputs listed
    in fb_idx (divergent segs or disagreeing values) are untouched and
    need the Python likelihood path."""
    lib = get_lib()
    K = len(a_seg)
    una_off = np.ascontiguousarray(una_off, np.int64)
    una_len = np.ascontiguousarray(una_len, np.int32)
    cnt = np.ascontiguousarray(cnt, np.int64)
    a_seg = np.ascontiguousarray(a_seg, np.int64)
    b_seg = np.ascontiguousarray(b_seg, np.int64)
    # exact bound: each output emits at most one contributing value
    pos_len = np.where(una_off >= 0, una_len.astype(np.int64), 0)
    cap = int(pos_len[a_seg[a_seg >= 0]].sum()
              + pos_len[b_seg[b_seg >= 0]].sum()) + 1
    blob = np.empty(cap, dtype=np.uint8)
    rx_off = np.empty(K, dtype=np.int64)
    rx_len = np.empty(K, dtype=np.int32)
    fb_idx = np.empty(max(K, 1), dtype=np.int64)
    used = np.zeros(1, dtype=np.int64)
    n_fb = lib.fgumi_duplex_rx_fast(
        _addr(buf), _addr(una_off), _addr(una_len), _addr(cnt),
        _addr(a_seg), _addr(b_seg), K, _addr(blob), cap, _addr(rx_off),
        _addr(rx_len), _addr(fb_idx), _addr(used))
    if n_fb < 0:
        raise RuntimeError("duplex RX blob overflow")
    return rx_off, rx_len, blob[:int(used[0])], fb_idx[:n_fb]


def umi_scan(buf: np.ndarray, off, length):
    """(has_n uint8[n], bases int32[n], ascii uint8[n]) per byte range;
    off < 0 -> (0, -1, 1)."""
    lib = get_lib()
    n = len(off)
    has_n = np.empty(n, dtype=np.uint8)
    bases = np.empty(n, dtype=np.int32)
    ascii_ = np.empty(n, dtype=np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    length = np.ascontiguousarray(length, np.int32)
    lib.fgumi_umi_scan(_addr(buf), _addr(off), _addr(length), n,
                       _addr(has_n), _addr(bases), _addr(ascii_))
    return has_n, bases, ascii_


def tag_name_list(buf: np.ndarray, aux_off, aux_end, max_per: int = 24):
    """Per-record aux tag names: (names uint16 (n, max_per), counts int32);
    counts[i] == -1 means too many or malformed (that template takes
    the per-record path)."""
    lib = get_lib()
    n = len(aux_off)
    names = np.empty((n, max_per), dtype=np.uint16)
    counts = np.empty(n, dtype=np.int32)
    ao = np.ascontiguousarray(aux_off, np.int64)
    ae = np.ascontiguousarray(aux_end, np.int64)
    lib.fgumi_tag_name_list(_addr(buf), _addr(ao), _addr(ae), n, max_per,
                            _addr(names), _addr(counts))
    return names, counts


def cigar_strings(buf: np.ndarray, cigar_off, n_cigar):
    """Batched CIGAR rendering: (blob bytes, (n+1,) int64 offsets)."""
    lib = get_lib()
    n = len(n_cigar)
    nc = np.ascontiguousarray(n_cigar, np.int32)
    co = np.ascontiguousarray(cigar_off, np.int64)
    cap = int(np.maximum(11 * nc.astype(np.int64), 1).sum())
    out = np.empty(cap, dtype=np.uint8)
    out_off = np.empty(n + 1, dtype=np.int64)
    rc = lib.fgumi_cigar_strings(_addr(buf), _addr(co), _addr(nc), n,
                                 _addr(out), _addr(out_off))
    if rc < 0:
        raise ValueError("invalid CIGAR op code")
    return out, out_off


def rebuild_aux_records(buf: np.ndarray, data_off, aux_off, data_end,
                        drop: np.ndarray, drop_off, appends: np.ndarray,
                        app_off):
    """Rebuild records with filtered aux + appended TLV bytes; returns
    (wire blob bytes incl. block_size prefixes, (n+1,) int64 offsets) or
    None when a record is malformed (the caller edits per record, as
    the reference does)."""
    lib = get_lib()
    n = len(data_off)
    do = np.ascontiguousarray(data_off, np.int64)
    ao = np.ascontiguousarray(aux_off, np.int64)
    de = np.ascontiguousarray(data_end, np.int64)
    dro = np.ascontiguousarray(drop_off, np.int64)
    apo = np.ascontiguousarray(app_off, np.int64)
    drop = np.ascontiguousarray(drop, np.uint16)
    appends = np.ascontiguousarray(appends, np.uint8)
    cap = int((de - do).sum() + (apo[-1] - apo[0]) + 4 * n)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    out_pos = np.empty(n + 1, dtype=np.int64)
    total = lib.fgumi_rebuild_aux_records(
        _addr(buf), _addr(do), _addr(ao), _addr(de), n, _addr(drop),
        _addr(dro), _addr(appends), _addr(apo), _addr(out), _addr(out_pos))
    if total < 0:
        return None
    return out[:total], out_pos


def concat_spans(srcs, src_id, off, length):
    """Concatenate spans from up to 8 source uint8 arrays: returns
    (blob uint8, (n+1,) int64 offsets). Zero-length spans are legal."""
    lib = get_lib()
    if len(srcs) > 8:
        raise ValueError("concat_spans takes at most 8 source buffers")
    n = len(src_id)
    addrs = np.zeros(8, dtype=np.int64)
    keep = [np.ascontiguousarray(s, np.uint8) for s in srcs]
    for i, s in enumerate(keep):
        addrs[i] = s.ctypes.data
    sid = np.ascontiguousarray(src_id, np.int32)
    so = np.ascontiguousarray(off, np.int64)
    sl = np.ascontiguousarray(length, np.int32)
    out = np.empty(max(int(sl[sl > 0].sum()), 1), dtype=np.uint8)
    out_off = np.empty(n + 1, dtype=np.int64)
    lib.fgumi_concat_spans(_addr(addrs), _addr(sid), _addr(so), _addr(sl), n,
                           _addr(out), _addr(out_off))
    del keep
    return out, out_off


def unclipped_5prime(batch):
    """Per-record unclipped 5' positions (int64[n]; meaningful for mapped
    records)."""
    lib = get_lib()
    out = np.empty(batch.n, dtype=np.int64)
    args = [np.ascontiguousarray(a) for a in (
        batch.cigar_off, batch.n_cigar, batch.flag, batch.pos)]
    lib.fgumi_unclipped_5prime(_addr(batch.buf), *map(_addr, args), batch.n,
                               _addr(out))
    return out


def rewrite_tag_records(batch, rows, tag: bytes, values, new_flags=None):
    """Wire blob for ``rows`` with ``tag`` replaced by per-row Z values.

    ``values``: a numpy S-array or a list of bytes, parallel to ``rows``.
    ``new_flags``: optional int32 FLAG per row (-1 keeps the record's; the
    dedup engine's duplicate bit). Returns the contiguous
    block_size-prefixed wire blob with every prior occurrence of the tag
    removed and the new value appended per record.
    Raises ValueError on a malformed aux region (the caller takes the
    per-record Python editor, whose output is identical)."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, np.int64)
    k = len(rows)
    if isinstance(values, np.ndarray) and values.dtype.kind == "S":
        # fixed-stride S-array: true lengths + stride offsets into the
        # array's own buffer (the NUL padding is never read)
        val_len = np.char.str_len(values).astype(np.int32)
        val_off = np.arange(k, dtype=np.int64) * values.dtype.itemsize
        v = np.ascontiguousarray(values)
        val_blob = v.view(np.uint8) if k else np.zeros(1, np.uint8)
    else:
        val_blob = np.frombuffer(b"".join(values) or b"\x00", dtype=np.uint8)
        val_len = np.array([len(v) for v in values], dtype=np.int32)
        val_off = (np.concatenate(([0], np.cumsum(val_len, dtype=np.int64)))
                   [:-1] if k else np.empty(0, dtype=np.int64))
    data_off = np.ascontiguousarray(batch.data_off[rows])
    data_end = np.ascontiguousarray(batch.data_end[rows])
    aux_off = np.ascontiguousarray(batch.aux_off[rows])
    cap = int(((data_end - data_off) + 8 + val_len).sum())
    out = np.empty(max(cap, 1), dtype=np.uint8)
    flags_arg = 0
    if new_flags is not None:
        new_flags = np.ascontiguousarray(new_flags, np.int32)
        flags_arg = _addr(new_flags)
    total = lib.fgumi_rewrite_tag_records(
        _addr(batch.buf), _addr(data_off), _addr(data_end), _addr(aux_off),
        k, tag[0], tag[1], _addr(val_blob), _addr(val_off), _addr(val_len),
        flags_arg, _addr(out))
    if total < 0:
        raise ValueError(f"malformed aux region in record {-(total + 1)}")
    return out[:total].tobytes()


def umi_neighbor_pairs(mat_a: np.ndarray, mat_b, d: int):
    """Candidate (i, j) pairs with hamming <= d by the d+1-part pigeonhole.

    ``mat_b`` None is the same-matrix case (each unordered pair once,
    i < j); otherwise every cross pair with i != j. Returns duplicate-free
    (i, j) int64 arrays."""
    lib = get_lib()
    mat_a = np.ascontiguousarray(mat_a, np.uint8)
    n, L = mat_a.shape
    if mat_b is None:
        b_ptr, m = _addr(mat_a), n
    else:
        mat_b = np.ascontiguousarray(mat_b, np.uint8)
        if mat_b.ndim != 2 or mat_b.shape[1] != L:
            raise ValueError(f"UMI matrices of {L} and {mat_b.shape} columns")
        b_ptr, m = _addr(mat_b), mat_b.shape[0]
    cap = max(4 * max(n, m), 4096)
    while True:
        out_i = np.empty(cap, dtype=np.int64)
        out_j = np.empty(cap, dtype=np.int64)
        count = lib.fgumi_umi_neighbor_pairs(_addr(mat_a), n, b_ptr, m, L,
                                             int(d), _addr(out_i),
                                             _addr(out_j), cap)
        if count <= cap:
            return out_i[:count], out_j[:count]
        cap = count


def adjacency_bfs(nbr_flat: np.ndarray, nbr_start: np.ndarray,
                  counts: np.ndarray):
    """Directed adjacency BFS roots: root_of int64[n]."""
    lib = get_lib()
    n = len(nbr_start) - 1
    nbr_flat = np.ascontiguousarray(nbr_flat, np.int64)
    nbr_start = np.ascontiguousarray(nbr_start, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    if len(counts) != n:
        raise ValueError(f"{len(counts)} counts for {n} nodes")
    root_of = np.empty(n, dtype=np.int64)
    lib.fgumi_adjacency_bfs(_addr(nbr_flat), _addr(nbr_start), _addr(counts),
                            n, _addr(root_of))
    return root_of


def template_coord_keys(batch, lib_ord: np.ndarray):
    """Packed template-coordinate sort keys for a whole RecordBatch.

    Returns (out uint8 blob, out_off int64[n+1]) — record i's key is
    out[out_off[i]:out_off[i+1]].
    """
    lib = get_lib()
    n = batch.n
    # only Z/H-typed tags count as present (RawRecord.get_str semantics);
    # e.g. an MI:i: tag must fall back to (0, 0) like the per-record path
    batch.prefetch_tags([b"MC", b"MI", b"RG"])  # one fused aux scan
    mc_off, mc_len, _ = batch.tag_locs_str(b"MC")
    mi_off, mi_len, _ = batch.tag_locs_str(b"MI")
    key_len = (30 + batch.l_read_name).astype(np.int64)  # 29 + name + NUL + up
    out_off = np.concatenate(([0], np.cumsum(key_len)))
    out = np.empty(int(out_off[-1]), dtype=np.uint8)
    args = [np.ascontiguousarray(a) for a in (
        batch.data_off, batch.l_read_name, batch.cigar_off, batch.n_cigar,
        batch.flag, batch.ref_id, batch.pos, batch.next_ref_id,
        batch.next_pos, mc_off, mc_len, mi_off, mi_len)]
    lib_ord = np.ascontiguousarray(lib_ord, np.int32)
    lib.fgumi_template_coord_keys(
        _addr(batch.buf), *(map(_addr, args)), _addr(lib_ord), n, _addr(out),
        _addr(out_off))
    return out, out_off


class NativeExtractError(ValueError):
    """Record-level extract failure; the caller re-runs the offending record
    through the per-record route to produce the canonical error message."""

    def __init__(self, code: int, record_index: int):
        super().__init__(f"extract error {code} at batch record {record_index}")
        self.code = code
        self.record_index = record_index


def extract_records(bufs, name_off, name_len, seq_off, seq_len, qual_off,
                    segments, qual_offset: int, rg: bytes,
                    store_umi_quals: bool):
    """Batched FASTQ -> unmapped-BAM record assembly (fgumi_extract_records).

    bufs: list of per-input uint8 chunk buffers; the offset/len arrays are
    (n_inputs, n) int64/int32; segments: flattened [(input, kind, len)] with
    kind 0=template 1=UMI 2=skip and len -1 = rest-of-read.
    Returns the block_size-prefixed wire blob (bytes).
    """
    lib = get_lib()
    n_inputs = len(bufs)
    n = name_off.shape[1]
    buf_addr = np.array([b.ctypes.data for b in bufs], dtype=np.int64)
    name_off = np.ascontiguousarray(name_off, np.int64)
    name_len = np.ascontiguousarray(name_len, np.int32)
    seq_off = np.ascontiguousarray(seq_off, np.int64)
    seq_len = np.ascontiguousarray(seq_len, np.int32)
    qual_off = np.ascontiguousarray(qual_off, np.int64)
    seg_input = np.array([s[0] for s in segments], dtype=np.int32)
    seg_kind = np.array([s[1] for s in segments], dtype=np.int32)
    seg_len = np.array([s[2] for s in segments], dtype=np.int32)
    n_templates = max(1, int((seg_kind == 0).sum()))
    max_name = int(name_len.max()) if n else 0
    # packed seq + quals appear once per read byte; the joined UMI (fixed M
    # segments only on this route) repeats in every emitted record's RX
    # and QX
    umi_total = int(seg_len[seg_kind == 1].sum()) + int((seg_kind == 1).sum())
    out_cap = (int(2 * seq_len.astype(np.int64).sum())
               + n * n_templates * (104 + max_name + len(rg) + 2 * umi_total)
               + 4096)
    out = np.empty(out_cap, dtype=np.uint8)
    state = np.zeros(2, dtype=np.int64)
    rg_arr = np.frombuffer(rg, dtype=np.uint8)
    rc = lib.fgumi_extract_records(
        n_inputs, n, _addr(buf_addr), _addr(name_off), _addr(name_len),
        _addr(seq_off), _addr(seq_len), _addr(qual_off), len(segments),
        _addr(seg_input), _addr(seg_kind), _addr(seg_len), qual_offset,
        _addr(rg_arr), len(rg), int(store_umi_quals), _addr(out), out_cap,
        _addr(state))
    if rc == -1:
        raise RuntimeError("extract output capacity overflow")
    if rc in (-2, -3, -4):
        raise NativeExtractError(int(rc), int(state[1]))
    return out[:int(state[0])].tobytes()


def natural_name_keys(batch):
    """Packed natural-queryname sort keys for a whole RecordBatch.

    Returns (out uint8 blob, out_off int64[n], out_len int32[n]): record
    i's key is out[out_off[i]:out_off[i] + out_len[i]].
    """
    lib = get_lib()
    n = batch.n
    # worst case 3 bytes a name byte (alternating one-byte digit and text
    # runs), the NUL and the 4-byte rank
    cap = (3 * batch.l_read_name + 2).astype(np.int64)
    out_off = np.concatenate(([0], np.cumsum(cap)))[:-1]
    out = np.empty(int(cap.sum()), dtype=np.uint8)
    out_len = np.empty(n, dtype=np.int32)
    args = [np.ascontiguousarray(a) for a in (
        batch.data_off, batch.l_read_name, batch.flag)]
    lib.fgumi_natural_name_keys(_addr(batch.buf), *(map(_addr, args)), n,
                                _addr(out), _addr(out_off), _addr(out_len))
    return out, out_off, out_len


def ref_spans(buf: np.ndarray, cigar_off, n_cigar, pos):
    """Per-record reference end: pos + the reference-consumed CIGAR
    length, at least pos + 1 (int32[n])."""
    lib = get_lib()
    n = len(pos)
    out = np.empty(n, dtype=np.int32)
    co = np.ascontiguousarray(cigar_off, np.int64)
    nc = np.ascontiguousarray(n_cigar, np.int32)
    ps = np.ascontiguousarray(pos, np.int32)
    lib.fgumi_ref_spans(_addr(buf), _addr(co), _addr(nc), _addr(ps), n,
                        _addr(out))
    return out


def qual_scores(batch, min_q: int, cap: int):
    """Per-record sum of the qualities >= min_q, capped at ``cap``
    (int32[n])."""
    lib = get_lib()
    out = np.empty(batch.n, dtype=np.int32)
    qual_off = np.ascontiguousarray(batch.qual_off)
    l_seq = np.ascontiguousarray(batch.l_seq)
    lib.fgumi_qual_scores(_addr(batch.buf), _addr(qual_off), _addr(l_seq),
                          batch.n, min_q, cap, _addr(out))
    return out


def gather_u16_arrays(buf: np.ndarray, val_off, L: int):
    """Dense (n, L) uint16 matrix from B:s/B:S tag values, zero-padded.

    Returns (values, counts): counts -1 where the tag is absent, -2 for a
    subtype that is not 16-bit (the caller re-runs that input per record).
    """
    lib = get_lib()
    n = len(val_off)
    out = np.empty((n, L), dtype=np.uint16)
    counts = np.empty(n, dtype=np.int32)
    val_off = np.ascontiguousarray(val_off, np.int64)
    lib.fgumi_gather_u16_arrays(_addr(buf), _addr(val_off), n, L, _addr(out),
                                _addr(counts))
    return out, counts


def apply_masks(batch, rows, mask: np.ndarray, skip_existing_n: bool):
    """In-place N/Q2 masking of ``rows``' seq and qual bytes.

    mask: (len(rows), L) over each record's first l_seq positions. Returns
    (newly_masked int32[k], n_after int32[k]). The batch's buffer must be
    writable: the native call writes through its address, past numpy's
    read-only guard.
    """
    if not batch.buf.flags.writeable:
        raise ValueError("apply_masks needs a writable record batch")
    lib = get_lib()
    rows = np.ascontiguousarray(rows, np.int64)
    k = len(rows)
    mask = np.ascontiguousarray(mask, np.uint8)
    seq_off = np.ascontiguousarray(batch.seq_off[rows])
    qual_off = np.ascontiguousarray(batch.qual_off[rows])
    l_seq = np.ascontiguousarray(batch.l_seq[rows])
    if mask.ndim != 2 or mask.shape[0] != k or (
            k and mask.shape[1] < int(l_seq.max())):
        raise ValueError(f"mask of shape {mask.shape} for {k} rows of up "
                         f"to {int(l_seq.max()) if k else 0} bases")
    newly = np.empty(k, dtype=np.int32)
    n_after = np.empty(k, dtype=np.int32)
    lib.fgumi_apply_masks(_addr(batch.buf), _addr(seq_off), _addr(qual_off),
                          _addr(l_seq), k, _addr(mask), mask.shape[1],
                          int(skip_existing_n), _addr(newly), _addr(n_after))
    return newly, n_after


def build_codec_records(seq_addr, qual_addr, cons_err_addr,
                        a_base, a_qual, a_depth, a_err,
                        b_base, b_qual, b_depth, b_err,
                        lens, name_addr, name_len, mi_addr, mi_len,
                        rx_addr, rx_len, rg: bytes, flags: int,
                        per_base_tags: bool):
    """Serialize J CODEC consensus records into one wire blob (each record
    with its block_size prefix): the byte-exact twin of
    CodecConsensusCaller._build_record (consensus/codec.py; reference
    codec_caller.rs:1374-1539). Every *_addr array holds raw element
    addresses (int64) into caller-owned arrays that stay referenced for
    the call: seq/qual/strand base and qual rows uint8, cons_err/depth/
    error rows int64, row j of length lens[j]. mi_len[j] < 0 skips MI;
    rx_addr[j] == 0 skips RX. Returns (blob bytes, rec_end int64[J])."""
    lib = get_lib()
    J = len(lens)
    lens = np.ascontiguousarray(lens, np.int32)
    name_len = np.ascontiguousarray(name_len, np.int32)
    mi_len = np.ascontiguousarray(mi_len, np.int32)
    rx_len = np.ascontiguousarray(rx_len, np.int32)
    (seq_addr, qual_addr, cons_err_addr, a_base, a_qual, a_depth, a_err,
     b_base, b_qual, b_depth, b_err, name_addr, mi_addr, rx_addr) = (
        np.ascontiguousarray(a, np.int64)
        for a in (seq_addr, qual_addr, cons_err_addr, a_base, a_qual,
                  a_depth, a_err, b_base, b_qual, b_depth, b_err, name_addr,
                  mi_addr, rx_addr))
    L64 = lens.astype(np.int64)
    per_rec = (4 + 32 + name_len.astype(np.int64) + 1 + (L64 + 1) // 2 + L64
               + (3 + len(rg) + 1) + 9 * 7
               + np.where(mi_len >= 0, 3 + mi_len.astype(np.int64) + 1, 0)
               + np.where(rx_addr != 0, 3 + rx_len.astype(np.int64) + 1, 0))
    if per_base_tags:
        per_rec = per_rec + 4 * (8 + 2 * L64) + 4 * (3 + L64 + 1)
    out_cap = int(per_rec.sum())
    out = np.empty(max(out_cap, 1), dtype=np.uint8)
    rec_end = np.empty(J, dtype=np.int64)
    rg_arr = np.frombuffer(rg + b"\0", dtype=np.uint8)
    total = lib.fgumi_build_codec_records(
        _addr(seq_addr), _addr(qual_addr), _addr(cons_err_addr),
        _addr(a_base), _addr(a_qual), _addr(a_depth), _addr(a_err),
        _addr(b_base), _addr(b_qual), _addr(b_depth), _addr(b_err),
        _addr(lens), J, _addr(name_addr), _addr(name_len), _addr(mi_addr),
        _addr(mi_len), _addr(rx_addr), _addr(rx_len), _addr(rg_arr), len(rg),
        int(flags), int(per_base_tags), _addr(out), out_cap, _addr(rec_end))
    if total == -2:
        raise ValueError("read name too long (exceeds 254 bytes)")
    if total < 0:
        raise RuntimeError("codec record serialization overflow")
    return out[:total].tobytes(), rec_end


def consensus_segments(codes2d: np.ndarray, quals2d: np.ndarray,
                       starts: np.ndarray, correct_tab: np.ndarray,
                       err_alt_tab: np.ndarray, g_sat: float, qual_const: int,
                       min_phred: int, tab1_winner: np.ndarray,
                       tab1_qual: np.ndarray, tab2_winner: np.ndarray,
                       tab2_qual: np.ndarray):
    """One f64 consensus pass over ragged segments (fgumi_consensus_segments;
    the host engine of ``ops/host_kernel.py``).

    Returns (winner (J,L) u8, qual (J,L) u8, depth (J,L) i32,
    errors (J,L) i32, slow_idx int64[K], slow_ll (K,4) f64,
    slow_obs (K,4) i32): fast/tabled positions are fully resolved; the K slow
    positions carry their bit-exact lane sums and observation counts for the
    caller's oracle epilogue. The slow buffers start at max(4096, J*L/8)
    entries and grow to the returned count when a batch overflows them.
    """
    faults.fire("native.batch")
    lib = get_lib()
    J = len(starts) - 1
    L = codes2d.shape[1] if codes2d.ndim == 2 else 0
    codes2d = np.ascontiguousarray(codes2d, dtype=np.uint8)
    quals2d = np.ascontiguousarray(quals2d, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    correct_tab = np.ascontiguousarray(correct_tab, dtype=np.float64)
    err_alt_tab = np.ascontiguousarray(err_alt_tab, dtype=np.float64)
    winner = np.empty((J, L), dtype=np.uint8)
    qual = np.empty((J, L), dtype=np.uint8)
    depth = np.empty((J, L), dtype=np.int32)
    errors = np.empty((J, L), dtype=np.int32)
    cap = max(4096, (J * L) // 8)
    while True:
        slow_idx = np.empty(cap, dtype=np.int64)
        slow_ll = np.empty((cap, 4), dtype=np.float64)
        slow_obs = np.empty((cap, 4), dtype=np.int32)
        n_slow = lib.fgumi_consensus_segments(
            _addr(codes2d), _addr(quals2d), _addr(starts), J, L,
            _addr(correct_tab), _addr(err_alt_tab),
            float(g_sat), int(qual_const), int(min_phred),
            _addr(tab1_winner), _addr(tab1_qual), _addr(tab2_winner),
            _addr(tab2_qual), _addr(winner), _addr(qual), _addr(depth),
            _addr(errors), _addr(slow_idx), _addr(slow_ll), _addr(slow_obs),
            cap)
        if n_slow <= cap:
            return (winner, qual, depth, errors, slow_idx[:n_slow],
                    slow_ll[:n_slow], slow_obs[:n_slow])
        cap = n_slow  # adversarial input: every position borderline
