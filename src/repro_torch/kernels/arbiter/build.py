"""Build ``csrc/arbiter.cu`` with nvcc at first use and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so a build
takes seconds. It goes to ``src/repro_torch/kernels/_build/<key>/``, which
``.gitignore`` lists, where ``<key>`` hashes every file under ``csrc/``
(the compiled source and anything it includes) and the flags: an edited
source builds anew, an unchanged one loads the existing library.
A build that fails raises with nvcc's output; nothing falls back to the
plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "arbiter.cu"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the arbiter kernels build from source at first use")


def library_path() -> Path:
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for f in sorted(SOURCE.parent.iterdir()):
        h.update(b"\0" + f.name.encode() + b"\0" + f.read_bytes())
    key = h.hexdigest()[:16]
    return BUILD_ROOT / key / "libarbiter.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. The
    compiler's output, register and shared-memory report included, is
    kept beside it in ``build.log``."""
    lib = library_path()
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build or a
    # build cut short never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C launchers' signatures."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.arbiter_priority_launch.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                            i32, i32, ptr]
    lib.arbiter_priority_launch.restype = i32
    lib.arbiter_topk_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.arbiter_topk_launch.restype = i32
    lib.arbiter_fused_launch.argtypes = ([ptr] * 5 + [i32] * 2
                                         + [ptr] * 5 + [i32] * 2
                                         + [ptr] * 3 + [i32] * 4 + [ptr])
    lib.arbiter_fused_launch.restype = i32
    lib.arbiter_error_string.argtypes = [i32]
    lib.arbiter_error_string.restype = ctypes.c_char_p
    return lib


__all__ = ["SOURCE", "BUILD_ROOT", "NVCC_FLAGS", "nvcc", "library_path",
           "build", "load_library"]
