"""The port's native host library: build and ctypes binding.

``fgumi_native.cc`` (a plain C interface, C++ standard library only) is
compiled by ``g++`` into ``fgumi_tpu_torch/_build/`` at first use and
loaded with ctypes. The output file is named by a hash of the source and
the flags, written to a temporary file and moved into place with
``os.replace``, so concurrent first users (test workers, processes) never
load a torn library; within one process a lock serialises build and load,
so the stages of a fused ``pipeline`` (one thread each) build it once. A
missing compiler, a failed build or a failed load raises: there is no
pure-Python fallback behind it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fgumi_native.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_LOCK = threading.Lock()
# one build at a time in this process (get_lib and direct build() callers)
_BUILD_LOCK = threading.Lock()


def library_path() -> str:
    """Build output path, keyed by the source and flags."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"fgumi_native_{digest.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile the library (no-op when already built); returns its path.
    Raises with the compiler's output on failure."""
    with _BUILD_LOCK:
        return _build_locked(force)


def _build_locked(force: bool) -> str:
    path = library_path()
    if os.path.exists(path) and not force:
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH: the native host "
                           "library cannot be built")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run([cxx] + CXX_FLAGS + ["-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees old or new
    return path


def _declare(lib):
    p = ctypes.c_void_p
    lg = ctypes.c_long
    lib.fgumi_find_record_boundaries.restype = lg
    lib.fgumi_find_record_boundaries.argtypes = [p, lg, p, lg, p]
    lib.fgumi_decode_fields.restype = None
    lib.fgumi_decode_fields.argtypes = [p, p, lg] + [p] * 12
    lib.fgumi_scan_tags.restype = None
    lib.fgumi_scan_tags.argtypes = [p, p, p, lg, p, lg, p, p, p]
    lib.fgumi_group_starts.restype = lg
    lib.fgumi_group_starts.argtypes = [p, p, p, lg, p]
    lib.fgumi_pack_reads.restype = None
    lib.fgumi_pack_reads.argtypes = [p, p, p, p, p, p, lg, ctypes.c_int, lg,
                                     ctypes.c_int, p, p, p]
    lib.fgumi_mate_clips.restype = None
    lib.fgumi_mate_clips.argtypes = [p] * 11 + [lg, p]
    lib.fgumi_ranges_equal.restype = None
    lib.fgumi_ranges_equal.argtypes = [p] * 5 + [lg, p]
    lib.fgumi_hash_ranges.restype = None
    lib.fgumi_hash_ranges.argtypes = [p, p, p, lg, p]
    lib.fgumi_overlap_correct_pairs.restype = None
    lib.fgumi_overlap_correct_pairs.argtypes = [p, p, p, lg, ctypes.c_int,
                                                ctypes.c_int, p]
    lib.fgumi_rx_unanimous.restype = None
    lib.fgumi_rx_unanimous.argtypes = [p, p, p, p, lg, p, p]
    lib.fgumi_build_consensus_records.restype = lg
    lib.fgumi_build_consensus_records.argtypes = (
        [p] * 6 + [lg, p, ctypes.c_int, p, p, p, p, p, ctypes.c_int,
                   ctypes.c_int, p, lg, p])
    lib.fgumi_build_duplex_records.restype = lg
    lib.fgumi_build_duplex_records.argtypes = (
        [p] * 5 + [lg, p, ctypes.c_int, p, p] + [p] * 5 + [p] * 6
        + [p, p, p, ctypes.c_int, ctypes.c_int, p, lg, p])
    lib.fgumi_build_codec_records.restype = lg
    lib.fgumi_build_codec_records.argtypes = (
        [p] * 11 + [p, lg] + [p] * 6
        + [p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, lg, p])
    lib.fgumi_segment_depth_errors.restype = None
    lib.fgumi_segment_depth_errors.argtypes = [p, p, p, lg, lg, p, p]
    lib.fgumi_segment_depth_errors_ranges.restype = None
    lib.fgumi_segment_depth_errors_ranges.argtypes = [p, p, p, p, lg, lg, p,
                                                      p]
    lib.fgumi_duplex_rx_fast.restype = lg
    lib.fgumi_duplex_rx_fast.argtypes = [p, p, p, p, p, p, lg, p, lg, p, p,
                                         p, p]
    lib.fgumi_umi_scan.restype = None
    lib.fgumi_umi_scan.argtypes = [p, p, p, lg, p, p, p]
    lib.fgumi_concat_spans.restype = lg
    lib.fgumi_concat_spans.argtypes = [p, p, p, p, lg, p, p]
    lib.fgumi_unclipped_5prime.restype = None
    lib.fgumi_unclipped_5prime.argtypes = [p] * 5 + [lg, p]
    u8 = ctypes.c_uint8
    lib.fgumi_rewrite_tag_records.restype = lg
    lib.fgumi_rewrite_tag_records.argtypes = [p] * 4 + [lg, u8, u8, p, p, p,
                                                        p, p]
    lib.fgumi_umi_neighbor_pairs.restype = lg
    lib.fgumi_umi_neighbor_pairs.argtypes = [p, lg, p, lg, lg, ctypes.c_int,
                                             p, p, lg]
    lib.fgumi_adjacency_bfs.restype = None
    lib.fgumi_adjacency_bfs.argtypes = [p, p, p, lg, p]
    ci = ctypes.c_int
    lib.fgumi_extract_records.restype = lg
    lib.fgumi_extract_records.argtypes = ([lg, lg] + [p] * 6 + [lg]
                                          + [p] * 3 + [ci, p, ci, ci, p, lg,
                                                       p])
    lib.fgumi_template_coord_keys.restype = lg
    lib.fgumi_template_coord_keys.argtypes = [p] * 15 + [lg, p, p]
    lib.fgumi_sort_spans.restype = None
    lib.fgumi_sort_spans.argtypes = [p, p, p, lg, p]
    lib.fgumi_gather_spans.restype = lg
    lib.fgumi_gather_spans.argtypes = [p, p, p, p, lg, p]
    lib.fgumi_write_run.restype = lg
    lib.fgumi_write_run.argtypes = [p] * 8 + [lg, lg]
    lib.fgumi_merge_open2.restype = p
    lib.fgumi_merge_open2.argtypes = [p, lg, lg, ci, lg]
    lib.fgumi_natural_name_keys.restype = lg
    lib.fgumi_natural_name_keys.argtypes = [p] * 4 + [lg, p, p, p]
    lib.fgumi_ref_spans.restype = None
    lib.fgumi_ref_spans.argtypes = [p] * 4 + [lg, p]
    lib.fgumi_qual_scores.restype = None
    lib.fgumi_qual_scores.argtypes = [p, p, p, lg, ci, lg, p]
    lib.fgumi_gather_u16_arrays.restype = None
    lib.fgumi_gather_u16_arrays.argtypes = [p, p, lg, lg, p, p]
    lib.fgumi_apply_masks.restype = None
    lib.fgumi_apply_masks.argtypes = [p] * 4 + [lg, p, lg, ci, p, p]
    lib.fgumi_merge_next.restype = lg
    lib.fgumi_merge_next.argtypes = [p, p, lg, p, lg, p]
    lib.fgumi_merge_close.restype = None
    lib.fgumi_merge_close.argtypes = [p]
    lib.fgumi_tag_name_list.restype = None
    lib.fgumi_tag_name_list.argtypes = [p, p, p, lg, lg, p, p]
    lib.fgumi_cigar_strings.restype = lg
    lib.fgumi_cigar_strings.argtypes = [p, p, p, lg, p, p]
    lib.fgumi_rebuild_aux_records.restype = lg
    lib.fgumi_rebuild_aux_records.argtypes = [p, p, p, p, lg, p, p, p, p, p,
                                              p]


def get_lib():
    """The loaded library, built first if needed (raises on failure)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                _declare(lib)
                _LIB = lib
    return _LIB
