"""Plain PyTorch versions of the wire-format consensus functions.

Device-agnostic: every function runs on whatever device its tensors lie on.
They are the CPU route of the port and the references the hand-written
CUDA kernels (ops/cuda_kernel.py) are held against.

Wire layout (1 byte per observation): code (2 bits) | qual-dictionary index
(6 bits) << 2, index 63 = invalid (N base or pad). A per-dispatch dictionary
of <= 63 f32 match contributions ``delta = f32(ln_correct) - f32(ln_err)``
re-indexes the (94,) quality tables losslessly. Batches with more than 63
distinct quals fall back to 2-bit packed codes + qual bytes (``packed2``).

Numerics: the lane contributions are sums of nonnegative f32 terms, and the
suspect guard band below holds for ANY summation order (derivation in the
comment block of ops/kernel.py), so ``index_add_`` (atomics on CUDA, any
order) is as good as a sequential sum: a non-suspect position is exact.
Nonfinite dictionary entries (a Q0-class observation's -inf) are zeroed per
observation and counted in ``poison``, which forces ``suspect`` at exactly
the (segment, position) cells such an observation touches — the same
treatment the CUDA kernel applies. Those cells are recomputed by the f64
oracle, so the resolved planes do not depend on it.
"""

import sys

import numpy as np
import torch

from ..constants import MAX_PHRED, MIN_PHRED, N_CODE

_LN_4_3_F32 = float(np.float32(np.log(4.0 / 3.0)))
_EPS32 = float(np.finfo(np.float32).eps)
_PHRED_PER_LN = float(np.float32(10.0 / np.log(10.0)))

# Suspect guard band floors (derivation: ops/kernel.py).
_QUAL_GUARD_FLOOR = 3e-4  # Phred units; absorbs O(eps32) evaluation error
_TIE_GUARD_FLOOR = 1e-5  # ln units; exact-tie ulp jitter

WIRE_INVALID = 0xFC  # qidx 63, code 0
QUAL_INVALID = 127  # packed2-layout qual sentinel for N/pad

#: calls of ``packed2_full`` on a CUDA device (the port's own route runs
#: the hand kernel K1-p2 there, so a main-path run counts none)
PACKED2_LAUNCHES = 0


# ------------------------------------------------------------ host layouts

def build_wire(codes: torch.Tensor, quals: torch.Tensor,
               delta94: torch.Tensor):
    """(wire (N, L) uint8, dict64 (64,) f32), or None when the batch has
    more than 63 distinct quality values (use ``pack_codes2``).
    ``delta94``: the (94,) f32 per-Phred match contribution."""
    hist = torch.bincount(quals.reshape(-1), minlength=256)
    vals = torch.nonzero(hist).reshape(-1)
    if len(vals) > 63:
        return None
    lut = torch.full((256,), 63, dtype=torch.uint8, device=quals.device)
    lut[vals] = torch.arange(len(vals), dtype=torch.uint8,
                             device=quals.device)
    wire = (lut[quals.long()] << 2) | torch.clamp(codes, max=3)
    wire[codes == N_CODE] = WIRE_INVALID
    dict64 = torch.zeros(64, dtype=torch.float32, device=quals.device)
    dict64[:len(vals)] = delta94[torch.clamp(vals, max=MAX_PHRED)]
    return wire, dict64


def pack_codes2(codes: torch.Tensor, quals: torch.Tensor):
    """The 1.25 B/position layout for >63 distinct quals: 2-bit codes
    packed 4 per byte along L, plus qual bytes with QUAL_INVALID marking
    N/pad positions (L % 4 == 0)."""
    c = torch.clamp(codes, max=3)
    N, L = c.shape
    c4 = c.reshape(N, L // 4, 4)
    cp = c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4) | (c4[..., 3] << 6)
    q = torch.where(codes == N_CODE,
                    torch.full_like(quals, QUAL_INVALID), quals)
    return cp.contiguous(), q


# ------------------------------------------------------ observation terms

def _terms(codes: torch.Tensor, valid: torch.Tensor, delta: torch.Tensor):
    """(one_hot (N, L, 4), delta (N, L), poison (N, L)) f32 with nonfinite
    entries zeroed and counted in poison."""
    one_hot = torch.nn.functional.one_hot(codes.long(), 4).to(torch.float32)
    one_hot = one_hot * valid[..., None].to(torch.float32)
    fin = torch.isfinite(delta)
    poison = (valid & ~fin).to(torch.float32)
    delta = torch.where(valid & fin, delta, torch.zeros_like(delta))
    return one_hot, delta, poison


def wire_terms(wire: torch.Tensor, dict_tab: torch.Tensor):
    """Per-observation terms from the 1-byte wire (dict_tab[63] == 0)."""
    qidx = (wire >> 2).long()
    return _terms(wire & 3, qidx != 63, dict_tab[qidx])


def packed2_terms(codes_packed: torch.Tensor, quals: torch.Tensor,
                  correct_tab: torch.Tensor, err_tab: torch.Tensor):
    """Per-observation terms from the packed2 layout."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8,
                          device=codes_packed.device)
    codes = ((codes_packed[..., None] >> shifts) & 3).reshape(
        codes_packed.shape[0], 4 * codes_packed.shape[1])
    q_idx = torch.clamp(quals, max=MAX_PHRED).long()
    return _terms(codes, quals != QUAL_INVALID,
                  (correct_tab - err_tab)[q_idx])


def _segment_sum(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg_ids, x)


# ---------------------------------------------------------------- epilogue

def call_epilogue(contrib: torch.Tensor, obs: torch.Tensor, ln_error_pre_umi,
                  poison: torch.Tensor = None):
    """Winner/tie/posterior/Phred epilogue over (..., L, 4) lane sums.

    Returns winner (int32, N_CODE for no-call), qual, depth, errors (int32)
    and suspect (bool): positions that need the f64 host recompute."""
    depth = obs.sum(dim=-1)
    max_c = contrib.max(dim=-1).values
    winner = torch.argmax(contrib, dim=-1)  # first occurrence of the max
    lane_is_winner = torch.nn.functional.one_hot(winner, 4).bool()
    winner = winner.to(torch.int32)

    # loser-gap frame: s = sum over losing lanes of exp(-(max - C_b))
    gaps = max_c[..., None] - contrib
    exp_neg = torch.where(lane_is_winner, torch.zeros_like(gaps),
                          torch.exp(-gaps))
    s = exp_neg.sum(dim=-1)
    ln_cons_err = torch.log(s) - torch.log1p(s)

    # two-trials combination with the pre-UMI prior (phred.rs:248-267), f32
    pre = torch.tensor(float(np.float32(ln_error_pre_umi)),
                       dtype=torch.float32, device=contrib.device)
    hi = torch.maximum(pre, ln_cons_err)
    lo = torch.minimum(pre, ln_cons_err)
    diff = hi - lo
    quick = ~(diff < 6.0)
    safe_diff = torch.where(quick, torch.full_like(diff, 6.0), diff)
    term1 = hi + torch.log1p(torch.exp(-safe_diff))
    term2_minus_term1 = _LN_4_3_F32 + lo - torch.log1p(torch.exp(-safe_diff))
    full = term1 + torch.log1p(-torch.exp(
        torch.clamp(term2_minus_term1, max=-_EPS32)))
    ln_final = torch.where(quick, hi, full)
    phred_f = -ln_final * _PHRED_PER_LN + 0.001
    qual = torch.clamp(torch.floor(phred_f), MIN_PHRED,
                       MAX_PHRED).to(torch.int32)

    # ---- suspect guard band (derivation: ops/kernel.py) ----
    eps_gap = _EPS32 * (depth.to(torch.float32) + 2.0) * (1.0 + max_c)
    second = torch.where(lane_is_winner,
                         torch.full_like(contrib, float("-inf")),
                         contrib).max(dim=-1).values
    margin = max_c - second
    tie_suspect = margin <= (2.0 * eps_gap + _TIE_GUARD_FLOOR)
    took_pre = quick & (ln_cons_err < pre)
    err_phred = torch.where(took_pre, torch.zeros_like(eps_gap),
                            _PHRED_PER_LN * 2.0 * eps_gap)
    frac = phred_f - torch.floor(phred_f)
    near_boundary = (torch.minimum(frac, 1.0 - frac)
                     <= (err_phred + _QUAL_GUARD_FLOOR))
    clamped = (phred_f <= MIN_PHRED) | (phred_f >= MAX_PHRED + 0.5)
    branch_suspect = torch.abs(diff - 6.0) <= (2.0 * eps_gap + 1e-4)
    nonfinite = ~torch.isfinite(max_c)
    if poison is not None:
        nonfinite = nonfinite | (poison > 0)
    suspect = (tie_suspect | branch_suspect | nonfinite
               | (near_boundary & ~clamped))

    no_call = depth == 0
    winner = torch.where(no_call | tie_suspect,
                         torch.full_like(winner, N_CODE), winner)
    qual = torch.where(no_call | tie_suspect,
                       torch.full_like(qual, MIN_PHRED), qual)
    suspect = suspect & ~no_call

    winner_obs = (obs * lane_is_winner).sum(dim=-1)
    errors = depth - torch.where(winner == N_CODE,
                                 torch.zeros_like(winner_obs), winner_obs)
    return winner, qual, depth.to(torch.int32), errors.to(torch.int32), suspect


def _reduce_and_call(terms, seg_ids, ln_error_pre_umi, num_segments,
                     with_obs: bool = False):
    one_hot, delta, poison = terms
    contrib = _segment_sum(delta[..., None] * one_hot, seg_ids, num_segments)
    obs = _segment_sum(one_hot, seg_ids, num_segments).to(torch.int32)
    pois = _segment_sum(poison, seg_ids, num_segments)
    out = call_epilogue(contrib, obs, ln_error_pre_umi, pois)
    return out + (obs,) if with_obs else out


def wire_epilogue(wire, seg_ids, dict_tab, ln_error_pre_umi,
                  num_segments: int):
    """(N, L) wire rows + sorted segment ids -> (winner, qual, depth,
    errors, suspect) per (segment, position)."""
    return _reduce_and_call(wire_terms(wire, dict_tab), seg_ids,
                            ln_error_pre_umi, num_segments)


# ------------------------------------------------------------ result words

def pack_result_split(winner, qual, suspect, out_segments: int):
    """qs (out_segments, L) uint8 = qual (7b) | suspect (1b) << 7; wp
    (out_segments, L/4) uint8 = winner 2-bit packed 4 per byte along L.
    The N winner is not encoded: tie positions carry the suspect bit and
    no-call positions are restored from depth == 0 on the host."""
    qs = (qual | (suspect.to(torch.int32) << 7))[:out_segments]
    w4 = torch.where(winner > 3, torch.zeros_like(winner),
                     winner)[:out_segments]
    w4 = w4.reshape(out_segments, w4.shape[-1] // 4, 4)
    wp = w4[..., 0] | (w4[..., 1] << 2) | (w4[..., 2] << 4) | (w4[..., 3] << 6)
    return qs.to(torch.uint8), wp.to(torch.uint8)


def unpack_result_split(qs: np.ndarray, wp: np.ndarray, J: int):
    """(winner 0..3, qual, suspect) host arrays from a split packed fetch."""
    qs = qs[:J]
    qual = (qs & 0x7F).astype(np.uint8)
    suspect = (qs >> 7).astype(bool)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    w4 = (wp[:J, :, None] >> shifts) & 3
    winner = w4.reshape(J, -1).astype(np.uint8)
    return winner, qual, suspect


def _full_outputs(out, out_segments: int):
    winner, qual, depth, errors, suspect = out
    qs, wp = pack_result_split(winner, qual, suspect, out_segments)
    # depth/errors ride as the low 16 bits in int16 storage (read them back
    # with .view(np.uint16)); callers gate on family size < 65536
    return (qs, wp, depth[:out_segments].to(torch.int16),
            errors[:out_segments].to(torch.int16))


def wire_full(wire, seg_ids, dict_tab, ln_error_pre_umi, num_segments: int,
              out_segments: int):
    """Full-column wire consensus: (qs u8, wp u8, depth u16, errors u16)
    sliced to ``out_segments`` rows — the function the CUDA kernel
    computes."""
    return _full_outputs(
        wire_epilogue(wire, seg_ids, dict_tab, ln_error_pre_umi,
                      num_segments), out_segments)


def wire_resident(wire, seg_ids, dict_tab, ln_error_pre_umi, min_reads: int,
                  min_qual: int, num_segments: int, out_segments: int):
    """Full-column wire consensus plus the duplex combine's resident
    arrays: the function the CUDA kernel ``consensus_wire_resident`` (K1-r)
    computes. Returns ``wire_full``'s (qs, wp, depth, errors) and (tb u8,
    tq u8, obs int32 (out_segments, L, 4)): tb/tq apply the consensus
    thresholds (oracle.apply_consensus_thresholds: depth < min_reads ->
    N/0, qual < min_qual -> N/MIN_PHRED) and obs holds the per-lane valid
    observation counts the combine's exact error recount reads. Values at
    suspect positions are the pre-oracle ones."""
    out = _reduce_and_call(wire_terms(wire, dict_tab), seg_ids,
                           ln_error_pre_umi, num_segments, with_obs=True)
    winner, qual, depth = (t[:out_segments] for t in out[:3])
    low_depth = depth < int(min_reads)
    low_qual = qual < int(min_qual)
    tb = torch.where(low_depth | low_qual, N_CODE, winner)
    tq = torch.where(low_depth, 0, torch.where(low_qual, MIN_PHRED, qual))
    return _full_outputs(out[:5], out_segments) + (
        tb.to(torch.uint8), tq.to(torch.uint8),
        out[5][:out_segments].contiguous())


#: i16 cap of the per-base depth/error tags (fgbio Short semantics)
I16_MAX = 32767
#: columns of the fused filter's per-read stats row (int32 each): max d16,
#: sum d16, sum e16, sum of thresholded quals, N count after the mask,
#: newly-masked count, any-suspect flag — every reduction over pos < lens
S_MAXD, S_SUMD, S_SUME, S_QSUM, S_NAFTER, S_NEWLY, S_SUSPECT = range(7)
STATS_COLS = 7


def wire_filter(wire, seg_ids, dict_tab, ln_error_pre_umi, min_reads_c,
                min_qual_c, lens, f_min_reads, emin_tab, f_min_base_q,
                per_base: bool, num_segments: int, out_segments: int):
    """Fused consensus→filter over the wire: the function the CUDA kernel
    ``consensus_wire_filter`` computes.

    Full-column consensus, then the consensus thresholds (``low depth`` →
    N/Q0, ``low qual`` → N/Q2, as oracle.apply_consensus_thresholds), the
    simplex per-base filter mask as integer compares (``emin_tab`` is
    consensus/filter.base_error_rate_table, so ``e16 >= emin_tab[d16]``
    equals the host's f64 ``e / d > max_rate``) and the quality mask, and
    the (out_segments, 7) int32 stats row. Returns (stats, fb u8, fq u8,
    depth, errors, qs u8, wp u8): depth/errors are the RAW u16 counts in
    int16 storage (the stats use the i16-capped values), qs/wp the
    pre-threshold split-packed words the suspect-row completion needs."""
    winner, qual, depth, errors, suspect = wire_epilogue(
        wire, seg_ids, dict_tab, ln_error_pre_umi, num_segments)
    qs, wp = pack_result_split(winner, qual, suspect, out_segments)
    w, q, d, e, sus = (t[:out_segments]
                       for t in (winner, qual, depth, errors, suspect))
    low_depth = d < int(min_reads_c)
    low_qual = q < int(min_qual_c)
    tb = torch.where(low_depth | low_qual, N_CODE, w)
    tq = torch.where(low_depth, 0, torch.where(low_qual, MIN_PHRED, q))
    L = wire.shape[1]
    in_len = (torch.arange(L, dtype=torch.int32, device=wire.device)[None, :]
              < lens.to(torch.int32)[:, None])
    d16 = torch.clamp(d, max=I16_MAX)
    e16 = torch.clamp(e, max=I16_MAX)
    fmask = torch.zeros_like(in_len)
    if per_base:
        fmask = (d16 < int(f_min_reads)) | (
            (d16 > 0) & (e16 >= emin_tab[d16.long()]))
    if int(f_min_base_q) >= 0:
        fmask = fmask | (tq < int(f_min_base_q))
    fmask = fmask & in_len
    fb = torch.where(fmask, N_CODE, tb)
    fq = torch.where(fmask, MIN_PHRED, tq)
    zero = torch.zeros_like(d16)
    stats = torch.stack([t.to(torch.int32) for t in (
        torch.amax(torch.where(in_len, d16, zero), dim=1),
        torch.where(in_len, d16, zero).sum(dim=1),
        torch.where(in_len, e16, zero).sum(dim=1),
        torch.where(in_len, tq, zero).sum(dim=1),
        (in_len & (fb == N_CODE)).sum(dim=1),
        (fmask & (tb != N_CODE)).sum(dim=1),
        (sus & in_len).any(dim=1),
    )], dim=1)
    return (stats, fb.to(torch.uint8), fq.to(torch.uint8),
            d.to(torch.int16), e.to(torch.int16), qs, wp)


def packed2_full(codes_packed, quals, seg_ids, correct_tab, err_tab,
                 ln_error_pre_umi, num_segments: int, out_segments: int):
    """Full-column consensus over the packed2 layout (same outputs as
    ``wire_full``): the function the CUDA kernel ``consensus_wire_packed2``
    (K1-p2) computes."""
    if codes_packed.is_cuda:
        from . import cuda_kernel

        cuda_kernel.count_launch(sys.modules[__name__], "PACKED2_LAUNCHES")
    terms = packed2_terms(codes_packed, quals, correct_tab, err_tab)
    return _full_outputs(
        _reduce_and_call(terms, seg_ids, ln_error_pre_umi, num_segments),
        out_segments)
