"""K4: the all-pairs UMI Hamming distance — binding, wrapper, plain version.

``csrc/umi_hamming.cu`` (built by :mod:`.cuda_kernel`) replaces the JAX
package's XLA device function ``fgumi_tpu/umi/assigners.py``
``_get_dist_jit`` (``dist``): ``out[i, k] = #{j : a[i, j] != b[k, j]}`` as
int16, integer-exact. :func:`umi_hamming` launches the kernel on CUDA
tensors and takes the plain PyTorch version, :func:`hamming_plain`, only
for CPU tensors; any other device, a failed build or a refused launch
raises — nothing falls back.
"""

import ctypes
import sys
import threading

import torch

from . import cuda_kernel

#: launches of K4 (bumped once per launch, nowhere else)
HAMMING_LAUNCHES = 0
#: the kernel's limits: int16 distances, and a persistent grid that walks
#: 32 x 256 output tiles counted in 32 bits
MAX_L = 32767
TILE_N = 32
TILE_M = 256
MAX_TILES = 2 ** 31 - 1
#: the plain version keeps each (chunk, M, L) bool under this many bytes
PLAIN_CHUNK_BYTES = 256 << 20

_LIB = None
_LOCK = threading.Lock()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of K4's launch, its scratch size and its
    error string; returns the library."""
    lib.fgumi_umi_hamming.restype = ctypes.c_int
    lib.fgumi_umi_hamming.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 3)
    lib.fgumi_umi_hamming_scratch_words.restype = ctypes.c_longlong
    lib.fgumi_umi_hamming_scratch_words.argtypes = [ctypes.c_int] * 3
    lib.fgumi_umi_hamming_error_string.restype = ctypes.c_char_p
    lib.fgumi_umi_hamming_error_string.argtypes = [ctypes.c_int]
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = bind(ctypes.CDLL(cuda_kernel.build_library("umi_hamming")))
            lib.fgumi_umi_hamming_geometry.restype = ctypes.c_int
            lib.fgumi_umi_hamming_geometry.argtypes = [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            _LIB = lib
    return _LIB


def launch(lib, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> int:
    """One K4 launch of build ``lib`` on PyTorch's current stream of
    ``out``'s device: ``a`` (n, L) x ``b`` (m, L) into ``out`` (n, m), with
    a scratch buffer of the size the build asks for (the bit planes of both
    matrices). Returns the launch's cudaError_t (0 on success)."""
    (n, L), m = a.shape, b.shape[0]
    words = lib.fgumi_umi_hamming_scratch_words(n, m, L)
    scratch = (torch.empty(words, dtype=torch.int32, device=out.device)
               if words > 0 else None)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return lib.fgumi_umi_hamming(
            a.data_ptr(), b.data_ptr(), n, m, L, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)


def hamming_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a broadcast compare summed to int16,
    over row chunks of ``a`` so that no (chunk, M, L) bool passes
    :data:`PLAIN_CHUNK_BYTES`."""
    n, L = a.shape
    m = b.shape[0]
    out = torch.empty((n, m), dtype=torch.int16, device=a.device)
    step = max(1, PLAIN_CHUNK_BYTES // max(1, m * L))
    for i in range(0, n, step):
        out[i:i + step] = (a[i:i + step, None, :] != b[None, :, :]).sum(
            dim=2, dtype=torch.int16)
    return out


def _check_inputs(a: torch.Tensor, b: torch.Tensor):
    """K4's input checks (both routes); returns (N, M, L)."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8:
            raise TypeError(f"umi_hamming {name}: expected torch.uint8, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"umi_hamming {name}: expected (rows, L), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"umi_hamming {name}: must be contiguous")
    (n, L), (m, L_b) = a.shape, b.shape
    if L_b != L:
        raise ValueError(f"umi_hamming: rows of unequal length {L} and {L_b}")
    if n < 1 or m < 1:
        raise ValueError(f"umi_hamming: empty input ({n} x {m} rows)")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"umi_hamming: L = {L} outside 1..{MAX_L}")
    if -(-n // TILE_N) * -(-m // TILE_M) > MAX_TILES:
        raise ValueError(f"umi_hamming: {n} x {m} outputs exceed the grid's "
                         f"{MAX_TILES} tiles of {TILE_N} x {TILE_M}")
    return n, m, L


def umi_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) int16 Hamming distances between the rows of ``a`` (N, L) and
    ``b`` (M, L), both contiguous uint8 on one device: K4 on CUDA, the
    plain version on the CPU."""
    dev = cuda_kernel.device_of("umi_hamming", a, b)
    n, m, L = _check_inputs(a, b)
    if dev.type == "cpu":
        return hamming_plain(a, b)
    lib = _lib()
    out = torch.empty((n, m), dtype=torch.int16, device=dev)
    rc = launch(lib, a, b, out)
    if rc != 0:
        msg = lib.fgumi_umi_hamming_error_string(rc).decode()
        raise RuntimeError(f"umi_hamming launch failed: {msg} "
                           f"(cudaError {rc})")
    cuda_kernel.count_launch(sys.modules[__name__], "HAMMING_LAUNCHES")
    return out


GEOMETRY_KEYS = ("grid", "threads", "shared_bytes", "tile_rows", "tile_cols",
                 "tiles", "blocks_per_sm", "sms", "bit_planes", "l_chunks")


def launch_geometry(n: int, m: int, L: int, device=None) -> dict:
    """K4's launch on ``device`` (default: the current CUDA device) for an
    (n, L) x (m, L) call: persistent grid blocks, threads a block, static
    shared bytes a block, the output tile, the tiles, resident blocks a SM
    (from the occupancy query the launch makes), SMs, 1 where the tiles
    compare bit planes (L <= 32) and 0 where they compare bytes, and the
    32-byte L chunks."""
    lib = _lib()
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        rc = lib.fgumi_umi_hamming_geometry(int(n), int(m), int(L), out)
    if rc != 0:
        msg = lib.fgumi_umi_hamming_error_string(rc).decode()
        raise ValueError(f"umi_hamming: no launch for ({n}, {m}, {L}): "
                         f"{msg}")
    return dict(zip(GEOMETRY_KEYS, list(out)))
