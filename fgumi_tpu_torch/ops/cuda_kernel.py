"""The hand-written CUDA kernels: build, binding, and the wire kernels'
wrappers.

Every CUDA source of the port (:data:`SOURCES`, plain C interfaces) is
compiled by ``nvcc`` for ``sm_90a`` into ``fgumi_tpu_torch/_build/`` at
first use and loaded with ctypes; :func:`build` compiles them all, one
``nvcc`` per source, started together. ``csrc/umi_hamming.cu`` (K4) has its
wrapper in ``ops/umi_hamming.py``, ``csrc/strand_combine.cu`` (the strand
combines K5 and K6) theirs in ``ops/combine.py``, ``csrc/canary.cu`` (the
device canary K7) and ``csrc/tune_combine.cu`` (the tuner's combine K8)
their own in ``ops/canary.py`` and ``ops/tune_combine.py``.
``csrc/consensus_wire.cu`` holds three kernels, all one warp per consensus
read on a persistent grid (their launch geometry:
:func:`full_launch_geometry`, :func:`filter_launch_geometry`,
:func:`resident_launch_geometry`):

- K1 ``consensus_wire_full`` — the Pallas ``_full_jit``/``call_full``
  (kind ``segwfp``); plain PyTorch version ``ops/wire.wire_full``;
- K1-f ``consensus_wire_filter`` — the Pallas ``_filter_jit``/
  ``call_filter`` (kind ``segwxp``), the same consensus plus the fused
  filter epilogue; plain PyTorch version ``ops/wire.wire_filter``;
- K1-r ``consensus_wire_resident`` — the XLA jit ``_wire_resident_fn``,
  K1 plus the thresholded tb/tq and the lane observation counts the duplex
  strand combine keeps on the card; plain PyTorch version
  ``ops/wire.wire_resident``;
- K1-p2 ``consensus_wire_packed2`` — the XLA jit ``_packed2_full_fn``, K1
  over the packed2 layout (2-bit codes and a qual byte a position) of the
  batches with more than 63 distinct quals; plain PyTorch version
  ``ops/wire.packed2_full``. It stages both planes of a read with
  ``cp.async``, as K1 stages its wire rows (its geometry:
  :func:`packed2_launch_geometry`).

Each wrapper takes the kernel on a CUDA tensor and the plain version on a
CPU tensor; any other device, a missing ``nvcc``, a failed build or a
refused launch raises — nothing falls back.
"""

import concurrent.futures as cf
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import torch

from . import wire as W

#: launches of K1 (bumped once per launch, nowhere else)
LAUNCHES = 0
#: launches of K1-f (bumped once per launch, nowhere else)
FILTER_LAUNCHES = 0
#: launches of K1-r (bumped once per launch, nowhere else)
RESIDENT_LAUNCHES = 0
#: launches of K1-p2 (bumped once per launch, nowhere else)
PACKED2_LAUNCHES = 0
#: guards the launch counters of every wrapper (:func:`count_launch`;
#: launches come from several threads: the stage runner's process stage and
#: resolve workers, two daemon jobs)
COUNT_LOCK = threading.Lock()
#: entries of the filter's per-base error-rate table (one per i16 depth)
EMIN_SIZE = 32768

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
#: every CUDA source of the port, by library name
SOURCES = {"consensus_wire": os.path.join(_CSRC, "consensus_wire.cu"),
           "umi_hamming": os.path.join(_CSRC, "umi_hamming.cu"),
           "strand_combine": os.path.join(_CSRC, "strand_combine.cu"),
           "canary": os.path.join(_CSRC, "canary.cu"),
           "tune_combine": os.path.join(_CSRC, "tune_combine.cu")}
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()
_BUILD_LOCKS = {name: threading.Lock() for name in SOURCES}
#: each library's last compiler output (``-Xptxas -v`` registers/spills)
BUILD_LOGS = {}
#: the compiler output of every library built so far, joined
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """Build output path of library ``name``, keyed by its source and the
    flags so an edited kernel is rebuilt."""
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build_library(name: str, force: bool = False) -> str:
    """Compile library ``name`` (no-op when it is already built); returns
    its path. Raises on a compiler error with nvcc's output."""
    global BUILD_LOG
    # one build of a library at a time in this process: the stages of a
    # fused pipeline run on threads and may reach their kernels together
    with _BUILD_LOCKS[name]:
        path = library_path(name)
        if os.path.exists(path) and not force:
            return path
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        BUILD_LOGS[name] = compile_source(SOURCES[name], tmp)
        BUILD_LOG = "\n".join(BUILD_LOGS.values())
        os.replace(tmp, path)  # atomic: other processes never see a torn .so
        return path


def build(force: bool = False) -> dict:
    """Compile every CUDA library of the port, one ``nvcc`` per source,
    all started together; returns {name: path}."""
    with cf.ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        futs = {name: ex.submit(build_library, name, force)
                for name in SOURCES}
        return {name: fut.result() for name, fut in futs.items()}


def compile_source(src: str, out: str) -> str:
    """``nvcc`` one kernel source into the shared library ``out`` with the
    port's flags; returns the compiler's output (the ``-Xptxas -v``
    report) and raises with it on a compiler error."""
    cmd = [_nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    return log


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded kernel library's two launch
    entry points and its error string; returns it."""
    fn = lib.fgumi_consensus_wire_full
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    fn = lib.fgumi_consensus_wire_filter
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)
    lib.fgumi_cuda_error_string.restype = ctypes.c_char_p
    lib.fgumi_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def bind_resident(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K1-r's launch export (a build from before K1-r has none and
    raises AttributeError); returns the library."""
    fn = lib.fgumi_consensus_wire_resident
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8)
    return lib


def bind_packed2(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K1-p2's launch export (a build from before K1-p2 has none
    and raises AttributeError); returns the library."""
    fn = lib.fgumi_consensus_wire_packed2
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = bind_packed2(bind_resident(bind(ctypes.CDLL(
                build_library("consensus_wire")))))
            for name in ("full", "filter", "resident", "packed2"):
                fn = getattr(lib, f"fgumi_consensus_wire_{name}_geometry")
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _LIB = lib
    return _LIB


def count_launch(module, counter: str):
    """Add one launch to ``module``'s counter ``counter`` (a module global
    such as ``LAUNCHES``) and to the launch tally of the active telemetry
    scope, if any. Every wrapper calls it once a launch, right after the
    launch succeeded, and nowhere else. One lock guards every counter, so
    the launches of concurrent commands (two jobs of the serve daemon) add
    up; the scope's tally keeps each command's own count apart
    (``cli._kernel_counters``)."""
    from ..observe.scope import current_scope

    scope = current_scope()
    with COUNT_LOCK:
        setattr(module, counter, getattr(module, counter) + 1)
        if scope is not None:
            scope.count_launch(f"{module.__name__}.{counter}")


def device_of(kernel: str, *tensors) -> torch.device:
    """The one device of a wrapper's inputs: CPU (the plain version) or
    CUDA (the kernel); raises on mixed or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: inputs on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _check_wire_inputs(wire, starts, dict_tab):
    """Shared K1/K1-f input checks; returns (N, L, J)."""
    if wire.dim() != 2:
        raise ValueError(f"wire: expected (N, L), got {tuple(wire.shape)}")
    N, L = wire.shape
    if L % 4:
        raise ValueError(f"wire: L={L} is not a multiple of 4")
    _check(wire, "wire", torch.uint8)
    _check(starts, "starts", torch.int32)
    _check(dict_tab, "dict_tab", torch.float32, (64,))
    _check_starts(starts, N)
    return N, L, starts.shape[0] - 1


def _check_starts(starts, N: int):
    """Segment bounds the kernels may index with: (J + 1,) with starts[0]
    == 0, never descending, and starts[J] <= N. Checked on a host copy
    (for a CUDA tensor, one (J + 1) x 4 B fetch and its sync)."""
    if starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError(f"starts: expected (J + 1,), got "
                         f"{tuple(starts.shape)}")
    s = starts.cpu().numpy()
    if s[0] != 0:
        raise ValueError("starts: must begin at 0")
    if (s[1:] < s[:-1]).any():
        raise ValueError("starts: must be ascending")
    if s[-1] > N:
        raise ValueError(f"starts: starts[J] = {s[-1]} exceeds the wire's "
                         f"{N} rows")


def _seg_ids(starts: torch.Tensor, J: int) -> torch.Tensor:
    counts = (starts[1:] - starts[:-1]).long()
    return torch.repeat_interleave(torch.arange(J, dtype=torch.int64), counts)


def _raise_launch(lib, name: str, rc: int):
    msg = lib.fgumi_cuda_error_string(rc).decode()
    raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


def consensus_wire_full(wire: torch.Tensor, starts: torch.Tensor,
                        dict_tab: torch.Tensor, ln_error_pre_umi):
    """Full-column consensus of every segment ``f`` over wire rows
    ``[starts[f], starts[f+1])``.

    wire (N, L) uint8 with L % 4 == 0; starts (J + 1,) int32 ascending with
    starts[J] <= N; dict_tab (64,) float32 with dict_tab[63] == 0. Returns
    (qs (J, L) u8, wp (J, L/4) u8, depth (J, L), errors (J, L)); depth and
    errors are u16 values in int16 storage (``.view(np.uint16)`` on host).
    """
    dev = device_of("consensus_wire_full", wire, starts, dict_tab)
    N, L, J = _check_wire_inputs(wire, starts, dict_tab)
    if dev.type == "cpu":
        return W.wire_full(wire[:int(starts[-1])], _seg_ids(starts, J),
                           dict_tab, ln_error_pre_umi, J, J)
    if wire.data_ptr() % 4:
        raise ValueError("wire: the kernel reads 4-byte words; the data "
                         "pointer must be 4-byte aligned")
    lib = _lib()
    qs = torch.empty((J, L), dtype=torch.uint8, device=dev)
    wp = torch.empty((J, L // 4), dtype=torch.uint8, device=dev)
    depth = torch.empty((J, L), dtype=torch.int16, device=dev)
    errors = torch.empty((J, L), dtype=torch.int16, device=dev)
    if J == 0:
        return qs, wp, depth, errors
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_consensus_wire_full(
            wire.data_ptr(), starts.data_ptr(), dict_tab.data_ptr(),
            float(np.float32(ln_error_pre_umi)), W._LN_4_3_F32, W._EPS32,
            W._PHRED_PER_LN, L, J, qs.data_ptr(), wp.data_ptr(),
            depth.data_ptr(), errors.data_ptr(), stream)
    if rc != 0:
        _raise_launch(lib, "consensus_wire_full", rc)
    count_launch(sys.modules[__name__], "LAUNCHES")
    return qs, wp, depth, errors


def consensus_wire_packed2(codes_packed: torch.Tensor, quals: torch.Tensor,
                           starts: torch.Tensor, correct_tab: torch.Tensor,
                           err_tab: torch.Tensor, ln_error_pre_umi):
    """K1 over the packed2 layout (K1-p2): full-column consensus of every
    segment ``f`` over rows ``[starts[f], starts[f+1])``.

    codes_packed (N, L/4) uint8: 2-bit base codes, 4 a byte along L (the
    first position in the low bits); quals (N, L) uint8 with
    ``QUAL_INVALID`` (127) at N bases and pad, L % 4 == 0; starts (J + 1,)
    int32 ascending with starts[J] <= N; correct_tab and err_tab (94,)
    float32, the match contribution of qual q being ``correct_tab[min(q,
    93)] - err_tab[min(q, 93)]``. Returns K1's (qs, wp, depth, errors)."""
    dev = device_of("consensus_wire_packed2", codes_packed, quals, starts,
                    correct_tab, err_tab)
    if quals.dim() != 2:
        raise ValueError(f"quals: expected (N, L), got {tuple(quals.shape)}")
    N, L = quals.shape
    if L % 4:
        raise ValueError(f"quals: L={L} is not a multiple of 4")
    _check(quals, "quals", torch.uint8)
    _check(codes_packed, "codes_packed", torch.uint8, (N, L // 4))
    _check(starts, "starts", torch.int32)
    _check(correct_tab, "correct_tab", torch.float32, (94,))
    _check(err_tab, "err_tab", torch.float32, (94,))
    _check_starts(starts, N)
    J = starts.shape[0] - 1
    if dev.type == "cpu":
        n = int(starts[-1])
        return W.packed2_full(codes_packed[:n], quals[:n],
                              _seg_ids(starts, J), correct_tab, err_tab,
                              ln_error_pre_umi, J, J)
    lib = _lib()
    qs = torch.empty((J, L), dtype=torch.uint8, device=dev)
    wp = torch.empty((J, L // 4), dtype=torch.uint8, device=dev)
    depth = torch.empty((J, L), dtype=torch.int16, device=dev)
    errors = torch.empty((J, L), dtype=torch.int16, device=dev)
    if J == 0:
        return qs, wp, depth, errors
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_consensus_wire_packed2(
            codes_packed.data_ptr(), quals.data_ptr(), starts.data_ptr(),
            correct_tab.data_ptr(), err_tab.data_ptr(),
            float(np.float32(ln_error_pre_umi)), W._LN_4_3_F32, W._EPS32,
            W._PHRED_PER_LN, L, J, qs.data_ptr(), wp.data_ptr(),
            depth.data_ptr(), errors.data_ptr(), stream)
    if rc != 0:
        _raise_launch(lib, "consensus_wire_packed2", rc)
    count_launch(sys.modules[__name__], "PACKED2_LAUNCHES")
    return qs, wp, depth, errors


def consensus_wire_resident(wire: torch.Tensor, starts: torch.Tensor,
                            dict_tab: torch.Tensor, ln_error_pre_umi,
                            min_reads: int, min_qual: int):
    """K1 plus the duplex combine's resident arrays for every segment
    ``f`` of wire rows ``[starts[f], starts[f+1])``.

    Inputs as :func:`consensus_wire_full`, plus the consensus thresholds
    ``min_reads``/``min_qual``. Returns K1's (qs, wp, depth, errors) and
    (tb (J, L) u8, tq (J, L) u8, obs (J, L, 4) int32): the thresholded
    bases/quals (depth < min_reads -> N/0, qual < min_qual -> N/MIN_PHRED)
    and the per-lane observation counts — see ops/wire.wire_resident."""
    dev = device_of("consensus_wire_resident", wire, starts, dict_tab)
    N, L, J = _check_wire_inputs(wire, starts, dict_tab)
    if dev.type == "cpu":
        return W.wire_resident(wire[:int(starts[-1])], _seg_ids(starts, J),
                               dict_tab, ln_error_pre_umi, min_reads,
                               min_qual, J, J)
    if wire.data_ptr() % 4:
        raise ValueError("wire: the kernel reads 4-byte words; the data "
                         "pointer must be 4-byte aligned")
    lib = _lib()
    qs = torch.empty((J, L), dtype=torch.uint8, device=dev)
    wp = torch.empty((J, L // 4), dtype=torch.uint8, device=dev)
    depth = torch.empty((J, L), dtype=torch.int16, device=dev)
    errors = torch.empty((J, L), dtype=torch.int16, device=dev)
    tb = torch.empty((J, L), dtype=torch.uint8, device=dev)
    tq = torch.empty((J, L), dtype=torch.uint8, device=dev)
    obs = torch.empty((J, L, 4), dtype=torch.int32, device=dev)
    if J == 0:
        return qs, wp, depth, errors, tb, tq, obs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_consensus_wire_resident(
            wire.data_ptr(), starts.data_ptr(), dict_tab.data_ptr(),
            float(np.float32(ln_error_pre_umi)), W._LN_4_3_F32, W._EPS32,
            W._PHRED_PER_LN, L, J, int(min_reads), int(min_qual),
            qs.data_ptr(), wp.data_ptr(), depth.data_ptr(),
            errors.data_ptr(), tb.data_ptr(), tq.data_ptr(), obs.data_ptr(),
            stream)
    if rc != 0:
        _raise_launch(lib, "consensus_wire_resident", rc)
    count_launch(sys.modules[__name__], "RESIDENT_LAUNCHES")
    return qs, wp, depth, errors, tb, tq, obs


def consensus_wire_filter(wire: torch.Tensor, starts: torch.Tensor,
                          dict_tab: torch.Tensor, ln_error_pre_umi,
                          min_reads_c: int, min_qual_c: int,
                          lens: torch.Tensor, f_min_reads: int,
                          emin_tab: torch.Tensor, f_min_base_q: int,
                          per_base: bool):
    """Fused consensus→filter over every segment ``f`` (one consensus read)
    of wire rows ``[starts[f], starts[f+1])``.

    Inputs as :func:`consensus_wire_full`, plus the consensus thresholds
    ``min_reads_c``/``min_qual_c``, lens (J,) int32 consensus lengths,
    the filter's per-base ``f_min_reads``, emin_tab (32768,) int32
    (consensus/filter.base_error_rate_table), ``f_min_base_q`` (< 0: off)
    and ``per_base`` (records carry cd/ce). Returns (stats (J, 7) int32,
    fb, fq (J, L) u8, depth, errors (J, L) raw u16 in int16 storage, qs
    (J, L) u8, wp (J, L/4) u8) — see ops/wire.wire_filter."""
    dev = device_of("consensus_wire_filter", wire, starts, dict_tab, lens,
                    emin_tab)
    N, L, J = _check_wire_inputs(wire, starts, dict_tab)
    _check(lens, "lens", torch.int32, (J,))
    _check(emin_tab, "emin_tab", torch.int32, (EMIN_SIZE,))
    if dev.type == "cpu":
        return W.wire_filter(wire[:int(starts[-1])], _seg_ids(starts, J),
                             dict_tab, ln_error_pre_umi, min_reads_c,
                             min_qual_c, lens, f_min_reads, emin_tab,
                             f_min_base_q, per_base, J, J)
    if wire.data_ptr() % 4:
        raise ValueError("wire: the kernel reads 4-byte words; the data "
                         "pointer must be 4-byte aligned")
    lib = _lib()
    stats = torch.empty((J, W.STATS_COLS), dtype=torch.int32, device=dev)
    fb = torch.empty((J, L), dtype=torch.uint8, device=dev)
    fq = torch.empty((J, L), dtype=torch.uint8, device=dev)
    depth = torch.empty((J, L), dtype=torch.int16, device=dev)
    errors = torch.empty((J, L), dtype=torch.int16, device=dev)
    qs = torch.empty((J, L), dtype=torch.uint8, device=dev)
    wp = torch.empty((J, L // 4), dtype=torch.uint8, device=dev)
    if J == 0:
        return stats, fb, fq, depth, errors, qs, wp
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_consensus_wire_filter(
            wire.data_ptr(), starts.data_ptr(), dict_tab.data_ptr(),
            float(np.float32(ln_error_pre_umi)), W._LN_4_3_F32, W._EPS32,
            W._PHRED_PER_LN, L, J, lens.data_ptr(), emin_tab.data_ptr(),
            int(min_reads_c), int(min_qual_c), int(f_min_reads),
            int(f_min_base_q), int(bool(per_base)), stats.data_ptr(),
            fb.data_ptr(), fq.data_ptr(), depth.data_ptr(),
            errors.data_ptr(), qs.data_ptr(), wp.data_ptr(), stream)
    if rc != 0:
        _raise_launch(lib, "consensus_wire_filter", rc)
    count_launch(sys.modules[__name__], "FILTER_LAUNCHES")
    return stats, fb, fq, depth, errors, qs, wp


def _launch_geometry(kernel: str, L: int, J: int, device) -> dict:
    lib = _lib()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        rc = getattr(lib, f"fgumi_consensus_wire_{kernel}_geometry")(
            int(L), int(J), out)
    if rc != 0:
        _raise_launch(lib, f"consensus_wire_{kernel}_geometry", rc)
    keys = ("grid", "warps_per_block", "shared_bytes", "blocks_per_sm",
            "slice_bytes", "sms")
    return dict(zip(keys, list(out)))


def full_launch_geometry(L: int, J: int, device=None) -> dict:
    """K1's launch on ``device`` (default: the current CUDA device) for J
    consensus reads of L columns: persistent grid size, warps per block,
    dynamic shared bytes per block, resident blocks per SM (from the
    occupancy query the launch makes), shared bytes per warp's slice and
    the SM count."""
    return _launch_geometry("full", L, J, device)


def filter_launch_geometry(L: int, J: int, device=None) -> dict:
    """K1-f's launch geometry, as :func:`full_launch_geometry` gives K1's
    (the same rule; the resident blocks per SM are K1-f's own)."""
    return _launch_geometry("filter", L, J, device)


def resident_launch_geometry(L: int, J: int, device=None) -> dict:
    """K1-r's launch geometry, as :func:`full_launch_geometry` gives K1's;
    its shared bytes also hold each warp's staging of a 128-column chunk's
    narrow planes, ``scratch_bytes`` a block."""
    geo = _launch_geometry("resident", L, J, device)
    geo["scratch_bytes"] = geo["shared_bytes"] - geo["warps_per_block"] * (
        geo["slice_bytes"] + 16)
    return geo


def packed2_launch_geometry(L: int, J: int, device=None) -> dict:
    """K1-p2's launch geometry, as :func:`full_launch_geometry` gives K1's:
    ``slice_bytes`` holds 16 rows of 1.25 L bytes (between 2 and 6 KB), and
    ``shared_bytes`` is a block's slices with 64 spare bytes each, beside
    the kernel's static 24,576-byte table."""
    return _launch_geometry("packed2", L, J, device)
