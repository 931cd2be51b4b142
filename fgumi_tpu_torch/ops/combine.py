"""The strand combines: K5, the duplex strand combine over K1-r's resident
arrays, and K6, the CODEC concordance combine — wrappers, binding and
plain PyTorch versions.

``csrc/strand_combine.cu`` (built by :mod:`.cuda_kernel`) holds both
kernels; they replace the JAX package's XLA jits:

- K5 :func:`duplex_combine` (``duplex_combine_kernel``) —
  ``fgumi_tpu/ops/kernel.py`` ``_duplex_combine_jit`` (the integer twin of
  the fast duplex engine's numpy combine); plain version
  :func:`duplex_combine_plain`;
- K6 :func:`codec_combine` (``codec_combine_kernel``) —
  ``_codec_combine_body``/``_codec_combine_jit`` (the twin of
  ``consensus/codec.combine_arrays``); plain version
  :func:`codec_combine_plain`.

Both are integer select/clip arithmetic, exact on every device. A wrapper
launches its kernel on CUDA tensors and takes the plain version only for
CPU tensors; any other device, a failed build or a refused launch raises —
nothing falls back. ``DUPLEX_COMBINE_LAUNCHES`` and
``CODEC_COMBINE_LAUNCHES`` count the kernels' launches.
"""

import ctypes
import sys
import threading

import torch

from ..constants import (MAX_PHRED, MIN_PHRED, N_CODE, NO_CALL_BASE,
                         NO_CALL_BASE_LOWER)
from . import cuda_kernel

#: i16 cap of the per-base depth/error tags (fgbio Short semantics)
I16_MAX = 32767

#: launches of K5 (bumped once per launch, nowhere else)
DUPLEX_COMBINE_LAUNCHES = 0
#: launches of K6 (bumped once per launch, nowhere else)
CODEC_COMBINE_LAUNCHES = 0

#: K6's eight inputs and six outputs, in the order of their arguments and
#: of the planes of one packed buffer (:func:`plane_views`)
CODEC_IN = (torch.uint8,) * 4 + (torch.int32,) * 4
CODEC_OUT = (torch.uint8, torch.uint8, torch.int32, torch.int32, torch.bool,
             torch.bool)
#: positions a K6 plane is padded to (one 16-byte word of a u8 plane)
PLANE_ALIGN = 16
#: the kernels' launch geometry (``fgumi_strand_combine_geometry``)
GEOMETRY_KEYS = ("grid", "threads", "blocks_per_sm", "sms")
_KERNEL_IDS = {"duplex_combine": 0, "codec_combine": 1}

_LIB = None
_LOCK = threading.Lock()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the two launch exports, the geometry
    query and the error string; returns the library."""
    fn = lib.fgumi_duplex_combine
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4)
    fn = lib.fgumi_codec_combine
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7)
    fn = lib.fgumi_strand_combine_geometry
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.fgumi_strand_combine_error_string.restype = ctypes.c_char_p
    lib.fgumi_strand_combine_error_string.argtypes = [ctypes.c_int]
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(cuda_kernel.build_library(
                "strand_combine")))
    return _LIB


def _raise_launch(lib, name: str, rc: int):
    msg = lib.fgumi_strand_combine_error_string(rc).decode()
    raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


def _check_aligned(name: str, tensors: dict):
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} {key}: the kernel makes 16-byte "
                             "accesses; the data pointer must be 16-byte "
                             "aligned")


def launch_geometry(kernel: str, work: int, device=None) -> dict:
    """The launch of ``kernel`` (``duplex_combine``: ``work`` output rows,
    a warp each; ``codec_combine``: ``work`` positions, 4 a thread) on
    ``device`` (default: the current CUDA device): grid blocks, threads a
    block, resident blocks a SM (the occupancy query the launch makes) and
    SMs."""
    lib = _lib()
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        rc = lib.fgumi_strand_combine_geometry(_KERNEL_IDS[kernel],
                                               int(work), out)
    if rc != 0:
        _raise_launch(lib, f"{kernel} geometry", rc)
    return dict(zip(GEOMETRY_KEYS, list(out)))


# --------------------------------------------------------------------- K5

def _check_duplex_inputs(tb, tq, obs, a_idx, b_idx, lens):
    """K5's input checks (both routes); returns (J, Lp, K)."""
    if tb.dim() != 2:
        raise ValueError(f"duplex_combine tb: expected (J, Lp), got "
                         f"{tuple(tb.shape)}")
    J, Lp = tb.shape
    if Lp % 4:
        raise ValueError(f"duplex_combine: Lp={Lp} is not a multiple of 4")
    K = a_idx.shape[0] if a_idx.dim() == 1 else -1
    for name, t, dtype, shape in (
            ("tb", tb, torch.uint8, (J, Lp)), ("tq", tq, torch.uint8, (J, Lp)),
            ("obs", obs, torch.int32, (J, Lp, 4)),
            ("a_idx", a_idx, torch.int32, (K,)),
            ("b_idx", b_idx, torch.int32, (K,)),
            ("lens", lens, torch.int32, (K,))):
        cuda_kernel._check(t, f"duplex_combine {name}", dtype, shape)
    return J, Lp, K


def _check_indices(a_idx, b_idx, J: int):
    """Every row index in [0, J) (K > 0), checked on a host copy of the
    two vectors' min and max (for CUDA tensors, an 8-byte fetch and its
    sync)."""
    lo, hi = torch.stack(torch.cat((a_idx, b_idx)).aminmax()).tolist()
    if lo < 0 or hi >= J:
        raise ValueError(f"duplex_combine: row indices span [{lo}, {hi}], "
                         f"outside the resident arrays' [0, {J})")


def duplex_combine(tb: torch.Tensor, tq: torch.Tensor, obs: torch.Tensor,
                   a_idx: torch.Tensor, b_idx: torch.Tensor,
                   lens: torch.Tensor):
    """Combine AB rows ``a_idx`` with BA rows ``b_idx`` of the resident
    single-strand arrays: tb, tq (J, Lp) uint8, obs (J, Lp, 4) int32, Lp %
    4 == 0; a_idx, b_idx (indices in [0, J)) and lens (K,) int32; all
    contiguous on one device. Returns (out_b (K, Lp) u8, out_q (K, Lp) u8,
    out_e (K, Lp) int32) as :func:`duplex_combine_plain` defines them: K5
    on CUDA, the plain version on the CPU."""
    dev = cuda_kernel.device_of("duplex_combine", tb, tq, obs, a_idx, b_idx,
                                lens)
    J, Lp, K = _check_duplex_inputs(tb, tq, obs, a_idx, b_idx, lens)
    if K == 0:
        return (torch.zeros((0, Lp), dtype=torch.uint8, device=dev),
                torch.zeros((0, Lp), dtype=torch.uint8, device=dev),
                torch.zeros((0, Lp), dtype=torch.int32, device=dev))
    _check_indices(a_idx, b_idx, J)
    if dev.type == "cpu":
        return duplex_combine_plain(tb, tq, obs, a_idx, b_idx, lens)
    _check_aligned("duplex_combine", {"tb": tb, "tq": tq, "obs": obs})
    lib = _lib()
    # the kernel writes every column of every row
    out_b = torch.empty((K, Lp), dtype=torch.uint8, device=dev)
    out_q = torch.empty((K, Lp), dtype=torch.uint8, device=dev)
    out_e = torch.empty((K, Lp), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_duplex_combine(
            tb.data_ptr(), tq.data_ptr(), obs.data_ptr(), a_idx.data_ptr(),
            b_idx.data_ptr(), lens.data_ptr(), K, Lp, out_b.data_ptr(),
            out_q.data_ptr(), out_e.data_ptr(), stream)
    if rc != 0:
        _raise_launch(lib, "duplex_combine", rc)
    cuda_kernel.count_launch(sys.modules[__name__], "DUPLEX_COMBINE_LAUNCHES")
    return out_b, out_q, out_e


def duplex_combine_plain(tb: torch.Tensor, tq: torch.Tensor,
                         obs: torch.Tensor, a_idx: torch.Tensor,
                         b_idx: torch.Tensor, lens: torch.Tensor):
    """Combine AB rows ``a_idx`` with BA rows ``b_idx`` of the resident
    single-strand arrays: tb, tq (S, L) uint8 (thresholded bases/quals),
    obs (S, L, 4) int32 (lane observation counts); a_idx, b_idx, lens (K,)
    integer. Returns (out_b (K, L) u8, out_q (K, L) u8, out_e (K, L)
    int32): agreeing bases sum their quals, disagreeing ones keep the
    higher-quality base at the difference, ties and either-N mask to N/Q2;
    errors are each side's valid observations that differ from the raw
    combined base, 0 where it is N or past ``lens``, capped at I16_MAX.
    Columns at or past ``lens`` are 0 in all three."""
    a_idx = a_idx.long()
    b_idx = b_idx.long()
    a_b = tb[a_idx].to(torch.int32)
    b_b = tb[b_idx].to(torch.int32)
    a_q = tq[a_idx].to(torch.int32)
    b_q = tq[b_idx].to(torch.int32)
    agree = a_b == b_b
    a_wins = ~agree & (a_q > b_q)
    b_wins = ~agree & (b_q > a_q)
    tie = ~agree & (a_q == b_q)
    raw_base = torch.where(agree | a_wins, a_b, b_b)
    raw_qual = torch.where(
        agree, torch.clamp(a_q + b_q, MIN_PHRED, MAX_PHRED),
        torch.where(a_wins, torch.clamp(a_q - b_q, MIN_PHRED, MAX_PHRED),
                    torch.where(b_wins,
                                torch.clamp(b_q - a_q, MIN_PHRED, MAX_PHRED),
                                MIN_PHRED)))
    mask = (a_b == N_CODE) | (b_b == N_CODE) | (raw_qual == MIN_PHRED) | tie
    L = tb.shape[1]
    in_len = (torch.arange(L, dtype=torch.int32, device=tb.device)[None, :]
              < lens.to(torch.int32)[:, None])
    keep = in_len & ~mask
    out_b = torch.where(keep, raw_base, torch.where(in_len, N_CODE, 0))
    out_q = torch.where(keep, raw_qual, torch.where(in_len, MIN_PHRED, 0))
    # exact per-base errors against the pre-mask raw duplex base: on each
    # side, valid observations minus those matching raw_base
    rb_l = torch.clamp(raw_base, max=3).long()[..., None]
    errs = torch.zeros_like(a_b)
    for idx in (a_idx, b_idx):
        side = obs[idx]
        errs += side.sum(dim=-1, dtype=torch.int32) \
            - torch.gather(side, -1, rb_l)[..., 0]
    errs = torch.where((raw_base == N_CODE) | ~in_len, 0, errs)
    return (out_b.to(torch.uint8), out_q.to(torch.uint8),
            torch.clamp(errs, max=I16_MAX))


def codec_combine_plain(ba, bb, qa, qb, da, db, ea, eb):
    """CODEC concordance combine of two strands' concatenated positions:
    ASCII bases ba, bb (u8, 'n' = pad), quals qa, qb (u8), depths da, db
    and errors ea, eb (int32, pre-capped at I16_MAX), all (T,). Returns
    (base u8, qual u8, depth int32, errors int32, both bool, disag bool),
    bit for bit ``consensus/codec.combine_arrays`` (agreement sums the
    quals to at most Q93, disagreement keeps the higher-quality base at the
    difference, a tie keeps base A at Q2, a duplex Q2 masks to N, either
    strand's uppercase N masks; depth capped at 2 x I16_MAX, errors at
    I16_MAX)."""
    ba, bb, qa, qb, da, db, ea, eb = (t.to(torch.int32) for t in
                                      (ba, bb, qa, qb, da, db, ea, eb))
    a_has = (ba != NO_CALL_BASE) & (ba != NO_CALL_BASE_LOWER)
    b_has = (bb != NO_CALL_BASE) & (bb != NO_CALL_BASE_LOWER)
    both = a_has & b_has
    agree = both & (ba == bb)
    a_wins = both & ~agree & (qa > qb)
    b_wins = both & ~agree & (qb > qa)
    tie = both & ~agree & (qa == qb)
    raw_base = torch.where(b_wins, bb, ba)
    raw_qual = torch.where(
        agree, torch.clamp(qa + qb, max=MAX_PHRED),
        torch.where(a_wins, torch.clamp(qa - qb, min=MIN_PHRED),
                    torch.where(b_wins, torch.clamp(qb - qa, min=MIN_PHRED),
                                torch.where(tie, MIN_PHRED, 0))))
    q_masked = both & (raw_qual == MIN_PHRED)
    dup_base = torch.where(q_masked, NO_CALL_BASE, raw_base)
    dup_qual = torch.where(q_masked, MIN_PHRED, raw_qual)
    dup_depth = torch.clamp(da, max=I16_MAX) + torch.clamp(db, max=I16_MAX)
    chose_a = agree | a_wins | tie
    dup_err = torch.where(
        agree, ea + eb,
        torch.where(chose_a, ea + torch.clamp(db - eb, min=0),
                    eb + torch.clamp(da - ea, min=0)))
    only_a = a_has & ~b_has
    only_b = b_has & ~a_has
    a_q2 = qa == MIN_PHRED
    b_q2 = qb == MIN_PHRED
    base = torch.where(
        both, dup_base,
        torch.where(only_a, torch.where(a_q2, NO_CALL_BASE, ba),
                    torch.where(only_b, torch.where(b_q2, NO_CALL_BASE, bb),
                                NO_CALL_BASE)))
    qual = torch.where(
        both, dup_qual,
        torch.where(only_a & ~a_q2, qa,
                    torch.where(only_b & ~b_q2, qb, MIN_PHRED)))
    depth = torch.where(both, dup_depth,
                        torch.where(only_a, da,
                                    torch.where(only_b, db, 0)))
    errors = torch.where(
        both, dup_err,
        torch.where(only_a, ea,
                    torch.where(only_b, eb,
                                torch.clamp(ea + eb, max=I16_MAX))))
    n_mask = (ba == NO_CALL_BASE) | (bb == NO_CALL_BASE)
    base = torch.where(n_mask, NO_CALL_BASE, base)
    qual = torch.where(n_mask, MIN_PHRED, qual)
    return (base.to(torch.uint8), qual.to(torch.uint8),
            torch.clamp(depth, max=2 * I16_MAX),
            torch.clamp(errors, max=I16_MAX), both, a_wins | b_wins | tie)


# --------------------------------------------------------------------- K6

def padded_positions(T: int) -> int:
    """T rounded up to :data:`PLANE_ALIGN`: the length of every plane of a
    packed K6 buffer."""
    return -(-T // PLANE_ALIGN) * PLANE_ALIGN


def plane_bytes(T: int, dtypes) -> int:
    """Bytes of one packed buffer of ``dtypes`` planes of T positions."""
    return padded_positions(T) * sum(torch.empty((), dtype=dt).element_size()
                                     for dt in dtypes)


def plane_views(buf: torch.Tensor, T: int, dtypes):
    """The (T,) views of a flat uint8 buffer of :func:`plane_bytes` (T,
    dtypes) bytes, laid out as consecutive planes of
    :func:`padded_positions` (T) elements, one a dtype: every plane starts
    at a multiple of 16 bytes from ``buf``'s first."""
    Tp = padded_positions(T)
    views, off = [], 0
    for dt in dtypes:
        n = Tp * torch.empty((), dtype=dt).element_size()
        views.append(buf[off:off + n].view(dt)[:T])
        off += n
    return views


def codec_combine(ba, bb, qa, qb, da, db, ea, eb, out=None):
    """The CODEC combine of T positions, :func:`codec_combine_plain`'s
    six results: ba, bb, qa, qb (T,) uint8, da, db, ea, eb (T,) int32, all
    contiguous on one device; K6 on CUDA (every tensor 16-byte aligned),
    the plain version on the CPU.

    ``out``: an optional flat uint8 buffer of at least ``plane_bytes(T,
    CODEC_OUT)`` bytes on the same device; the results are then written
    into it and returned as its :func:`plane_views` (one fetch takes all
    six). Without it each result has its own tensor on CUDA too."""
    ins = (ba, bb, qa, qb, da, db, ea, eb)
    dev = cuda_kernel.device_of("codec_combine", *ins,
                                *(() if out is None else (out,)))
    T = ba.shape[0] if ba.dim() == 1 else -1
    for name, t, dtype in zip(("ba", "bb", "qa", "qb", "da", "db", "ea",
                               "eb"), ins, CODEC_IN):
        cuda_kernel._check(t, f"codec_combine {name}", dtype, (T,))
    if out is not None:
        cuda_kernel._check(out, "codec_combine out", torch.uint8)
        if out.dim() != 1 or out.numel() < plane_bytes(T, CODEC_OUT):
            raise ValueError(f"codec_combine out: expected a flat buffer of "
                             f">= {plane_bytes(T, CODEC_OUT)} bytes, got "
                             f"{tuple(out.shape)}")
    if dev.type == "cpu":
        res = codec_combine_plain(*ins)
        if out is None:
            return res
        views = plane_views(out, T, CODEC_OUT)
        for v, r in zip(views, res):
            v.copy_(r)
        return tuple(views)
    if out is None:
        res = tuple(torch.empty(T, dtype=dt, device=dev) for dt in CODEC_OUT)
    else:
        res = tuple(plane_views(out, T, CODEC_OUT))
    if T == 0:
        return res
    _check_aligned("codec_combine", {
        **dict(zip(("ba", "bb", "qa", "qb", "da", "db", "ea", "eb"), ins)),
        **dict(zip(("base", "qual", "depth", "errors", "both", "disag"),
                   res))})
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_codec_combine(
            *(t.data_ptr() for t in ins), T, *(t.data_ptr() for t in res),
            stream)
    if rc != 0:
        _raise_launch(lib, "codec_combine", rc)
    cuda_kernel.count_launch(sys.modules[__name__], "CODEC_COMBINE_LAUNCHES")
    return res
