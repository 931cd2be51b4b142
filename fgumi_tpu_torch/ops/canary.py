"""K7: the device canary's int32 sum — binding, wrapper, plain version.

``csrc/canary.cu`` (built by :mod:`.cuda_kernel`) replaces the JAX
package's XLA device function ``fgumi_tpu/ops/kernel.py``
``_canary_sum_jit``: the int32 sum of a uint8 vector, exact in any order.
:func:`canary_sum` launches the kernel on a CUDA tensor and takes the plain
PyTorch version, :func:`canary_sum_plain`, only for a CPU tensor; any other
device, a failed build or a refused launch raises — nothing falls back.
The health monitor's round trip (``ops/kernel.device_canary``) is its one
caller on the main path.
"""

import ctypes
import sys
import threading

import torch

from . import cuda_kernel

#: launches of K7 (bumped once per launch, nowhere else)
CANARY_LAUNCHES = 0
#: the largest input whose sum fits int32 whatever its bytes (255 a byte)
MAX_BYTES = (2 ** 31 - 1) // 255
#: the kernel's launch geometry (``fgumi_canary_sum_geometry``)
GEOMETRY_KEYS = ("grid", "threads")

_LIB = None
_LOCK = threading.Lock()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of K7's launch, its geometry and its error
    string; returns the library."""
    lib.fgumi_canary_sum.restype = ctypes.c_int
    lib.fgumi_canary_sum.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.fgumi_canary_sum_geometry.restype = ctypes.c_int
    lib.fgumi_canary_sum_geometry.argtypes = [ctypes.c_longlong,
                                              ctypes.c_void_p]
    lib.fgumi_canary_error_string.restype = ctypes.c_char_p
    lib.fgumi_canary_error_string.argtypes = [ctypes.c_int]
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(ctypes.CDLL(cuda_kernel.build_library("canary")))
    return _LIB


def launch_geometry(n: int) -> dict:
    """K7's launch over ``n`` bytes: grid blocks and threads a block."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    _lib().fgumi_canary_sum_geometry(int(n), out)
    return dict(zip(GEOMETRY_KEYS, list(out)))


def canary_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x`` widened to int32 and summed in
    int32 (the JAX function's ``jnp.sum(x.astype(jnp.int32))``)."""
    return x.to(torch.int32).sum(dtype=torch.int32)


def _check(x: torch.Tensor) -> int:
    """K7's input checks (both routes); returns the byte count."""
    if x.dtype != torch.uint8:
        raise TypeError(f"canary_sum: expected torch.uint8, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"canary_sum: expected (n,), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("canary_sum: must be contiguous")
    n = x.shape[0]
    if not 1 <= n <= MAX_BYTES:
        raise ValueError(f"canary_sum: n = {n} outside 1..{MAX_BYTES} (the "
                         "int32 sum could overflow past it)")
    return n


def canary_sum(x: torch.Tensor) -> torch.Tensor:
    """The int32 sum of ``x`` ((n,) contiguous uint8) as a 0-d int32 tensor
    on ``x``'s device: K7 on CUDA, on PyTorch's current stream; the plain
    version on the CPU."""
    dev = cuda_kernel.device_of("canary_sum", x)
    n = _check(x)
    if dev.type == "cpu":
        return canary_sum_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("canary_sum: the kernel makes 16-byte loads; the "
                         "data pointer must be 16-byte aligned")
    lib = _lib()
    out = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fgumi_canary_sum(x.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.fgumi_canary_error_string(rc).decode()
        raise RuntimeError(f"canary_sum launch failed: {msg} "
                           f"(cudaError {rc})")
    cuda_kernel.count_launch(sys.modules[__name__], "CANARY_LAUNCHES")
    return out.reshape(())
