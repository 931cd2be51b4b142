"""The hand-written CUDA wire kernels: build, binding, wrappers.

``csrc/consensus_wire.cu`` (plain C interface) is compiled by ``nvcc`` for
``sm_90a`` into ``fgumi_tpu_torch/_build/`` at first use and loaded with
ctypes. It holds two kernels that replace the JAX package's Pallas
dispatches, both one warp per consensus read on a persistent grid (their
launch geometry: :func:`full_launch_geometry`,
:func:`filter_launch_geometry`):

- K1 ``consensus_wire_full`` — ``_full_jit``/``call_full`` (kind
  ``segwfp``); plain PyTorch version ``ops/wire.wire_full``;
- K1-f ``consensus_wire_filter`` — ``_filter_jit``/``call_filter`` (kind
  ``segwxp``), the same consensus plus the fused filter epilogue; plain
  PyTorch version ``ops/wire.wire_filter``.

Each wrapper takes the kernel on a CUDA tensor and the plain version on a
CPU tensor; any other device, a missing ``nvcc``, a failed build or a
refused launch raises — nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from . import wire as W

#: launches of K1 (bumped once per launch, nowhere else)
LAUNCHES = 0
#: launches of K1-f (bumped once per launch, nowhere else)
FILTER_LAUNCHES = 0
#: entries of the filter's per-base error-rate table (one per i16 depth)
EMIN_SIZE = 32768

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "consensus_wire.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None
_LOCK = threading.Lock()
#: the last build's compiler output (``-Xptxas -v`` register/spill report)
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA consensus kernel cannot be built")


def library_path() -> str:
    """Build output path, keyed by the source and flags so an edited
    kernel is rebuilt."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"consensus_wire_{digest.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the kernel library (no-op when it is already built);
    returns its path. Raises on a compiler error with nvcc's output."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    BUILD_LOG = compile_source(_SRC, tmp)
    os.replace(tmp, path)  # atomic: concurrent builders never see a torn .so
    return path


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


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = bind(ctypes.CDLL(build()))
            for name in ("full", "filter"):
                fn = getattr(lib, f"fgumi_consensus_wire_{name}_geometry")
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _LIB = lib
    return _LIB


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
    return N, L, starts.shape[0] - 1


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
    global LAUNCHES
    N, L, J = _check_wire_inputs(wire, starts, dict_tab)
    devices = {wire.device, starts.device, dict_tab.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    dev = wire.device
    if dev.type == "cpu":
        return W.wire_full(wire[:int(starts[-1])], _seg_ids(starts, J),
                           dict_tab, ln_error_pre_umi, J, J)
    if dev.type != "cuda":
        raise ValueError(f"consensus_wire_full: unsupported device {dev}")
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
    LAUNCHES += 1
    return qs, wp, depth, errors


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
    global FILTER_LAUNCHES
    N, L, J = _check_wire_inputs(wire, starts, dict_tab)
    _check(lens, "lens", torch.int32, (J,))
    _check(emin_tab, "emin_tab", torch.int32, (EMIN_SIZE,))
    devices = {wire.device, starts.device, dict_tab.device, lens.device,
               emin_tab.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    dev = wire.device
    if dev.type == "cpu":
        return W.wire_filter(wire[:int(starts[-1])], _seg_ids(starts, J),
                             dict_tab, ln_error_pre_umi, min_reads_c,
                             min_qual_c, lens, f_min_reads, emin_tab,
                             f_min_base_q, per_base, J, J)
    if dev.type != "cuda":
        raise ValueError(f"consensus_wire_filter: unsupported device {dev}")
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
    FILTER_LAUNCHES += 1
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
