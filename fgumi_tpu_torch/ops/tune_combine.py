"""K8: the tuner's elementwise combine — binding, wrapper, plain version.

``csrc/tune_combine.cu`` (built by :mod:`.cuda_kernel`) replaces the JAX
package's XLA device function ``fgumi_tpu/tune/autotune.py`` ``dev_combine``
(jitted in ``_bench_choosers``): ``where(x == y, min(x, y) + 3, max(x, y) -
min(x, y))`` over two uint8 arrays, in wrapping 8-bit arithmetic.
:func:`tune_combine` launches the kernel on CUDA tensors and takes the plain
PyTorch version, :func:`tune_combine_plain`, only for CPU tensors; any other
device, a failed build or a refused launch raises — nothing falls back.
The tuner's chooser micro-bench (``tune/autotune._bench_choosers``) is its
one caller on the main path.
"""

import ctypes
import sys
import threading

import torch

from . import cuda_kernel

#: launches of K8 (bumped once per launch, nowhere else)
TUNE_COMBINE_LAUNCHES = 0
#: the kernel's launch geometry (``fgumi_tune_combine_geometry``)
GEOMETRY_KEYS = ("grid", "threads", "vector")

_LIB = None
_LOCK = threading.Lock()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of K8's launch, its geometry and its error
    string; returns the library."""
    lib.fgumi_tune_combine.restype = ctypes.c_int
    lib.fgumi_tune_combine.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.fgumi_tune_combine_geometry.restype = ctypes.c_int
    lib.fgumi_tune_combine_geometry.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.fgumi_tune_combine_error_string.restype = ctypes.c_char_p
    lib.fgumi_tune_combine_error_string.argtypes = [ctypes.c_int]
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(cuda_kernel.build_library(
                "tune_combine")))
    return _LIB


def launch_geometry(n: int, vector: bool = True) -> dict:
    """K8's launch over ``n`` bytes: grid blocks, threads a block, and
    whether the 16-byte path runs (every pointer 16-byte aligned)."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    _lib().fgumi_tune_combine_geometry(int(n), int(bool(vector)), out)
    return dict(zip(GEOMETRY_KEYS, list(out)))


def tune_combine_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the JAX function's ``jnp.where`` in uint8
    (``min + 3`` wraps past 255)."""
    lo = torch.minimum(x, y)
    return torch.where(x == y, lo + 3, torch.maximum(x, y) - lo)


def _check(x: torch.Tensor, y: torch.Tensor):
    """K8's input checks (both routes)."""
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.uint8:
            raise TypeError(f"tune_combine: {name}: expected torch.uint8, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"tune_combine: {name}: must be contiguous")
    if x.shape != y.shape:
        raise ValueError(f"tune_combine: shapes differ: {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")


def tune_combine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The combine of ``x`` and ``y`` (contiguous uint8 of one shape) as a
    new uint8 tensor of that shape on their device: K8 on CUDA, on
    PyTorch's current stream; the plain version on the CPU."""
    dev = cuda_kernel.device_of("tune_combine", x, y)
    _check(x, y)
    if dev.type == "cpu":
        return tune_combine_plain(x, y)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_tune_combine(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, stream)
    if rc != 0:
        msg = lib.fgumi_tune_combine_error_string(rc).decode()
        raise RuntimeError(f"tune_combine launch failed: {msg} "
                           f"(cudaError {rc})")
    cuda_kernel.count_launch(sys.modules[__name__], "TUNE_COMBINE_LAUNCHES")
    return out
