"""The arbitration kernels' library: ``csrc/arbiter.cu``, built and
loaded by the port's one builder (:mod:`repro_torch.kernels.build`)."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels.build import (BUILD_ROOT, NVCC_FLAGS,  # noqa: F401
                                       CudaLibrary, nvcc)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.arbiter_priority_launch.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                            i32, i32, i32, i32, ptr]
    lib.arbiter_priority_launch.restype = i32
    lib.arbiter_topk_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                        ptr]
    lib.arbiter_topk_launch.restype = i32
    lib.arbiter_fused_launch.argtypes = ([ptr] * 5 + [i32] * 2
                                         + [ptr] * 5 + [i32] * 2
                                         + [ptr] * 3 + [i32] * 6 + [ptr])
    lib.arbiter_fused_launch.restype = i32
    lib.arbiter_ring_insert_launch.argtypes = ([ptr] * 4 + [i32] * 3
                                               + [ptr] * 6 + [i32, ptr, ptr])
    lib.arbiter_ring_insert_launch.restype = i32
    lib.arbiter_error_string.argtypes = [i32]
    lib.arbiter_error_string.restype = ctypes.c_char_p


LIBRARY = CudaLibrary("arbiter", Path(__file__).resolve().parent / "csrc",
                      _declare)
library_path = LIBRARY.library_path
load_library = LIBRARY.load

__all__ = ["BUILD_ROOT", "NVCC_FLAGS", "LIBRARY", "nvcc", "library_path",
           "load_library"]
