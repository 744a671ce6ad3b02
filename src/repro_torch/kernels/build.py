"""Build a kernel library's ``csrc/`` with nvcc at first use and load it
with ctypes.

Each library (``arbiter``, ``ssd``, ``attention``) is a
:class:`CudaLibrary`: a source
directory whose ``*.cu`` files compile into one shared library with a
plain C interface (no PyTorch headers), so a build takes seconds, with
headers shared between libraries taken from its include directories
(``-I``; ``COMMON`` holds ``hopper.cuh``, the Hopper PTX helpers of the
tensor-core kernels). It goes
to ``src/repro_torch/kernels/_build/<key>/lib<name>.so``, which
``.gitignore`` lists, where ``<key>`` hashes the library's name, every
file under its ``csrc/`` and under its include directories (the compiled
sources and anything they include) and the flags: an edited source or
shared header builds anew, an unchanged one loads the existing library.
A build that fails raises with nvcc's output; nothing falls back to a
plain PyTorch version. Two libraries build independently
(each under its own key), so they can build at the same time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

BUILD_ROOT = Path(__file__).resolve().parent / "_build"
COMMON = Path(__file__).resolve().parent / "common"
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
                       "the CUDA kernels build from source at first use")


class CudaLibrary:
    """The ``*.cu`` files of ``csrc`` as ``lib<name>.so``, with the
    headers of ``include_dirs`` on the include path; ``declare`` sets the
    C launchers' ``argtypes``/``restype`` on the loaded library."""

    def __init__(self, name: str, csrc: Path,
                 declare: Callable[[ctypes.CDLL], None],
                 include_dirs: tuple[Path, ...] = ()):
        self.name, self.csrc, self.declare = name, Path(csrc), declare
        self.include_dirs = tuple(Path(d) for d in include_dirs)
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    @property
    def sources(self) -> list[Path]:
        return sorted(self.csrc.glob("*.cu"))

    def library_path(self) -> Path:
        h = hashlib.sha256("\0".join((self.name,) + NVCC_FLAGS).encode())
        # by file name and content, not by path: a checkout elsewhere
        # keys the same sources alike
        for i, d in enumerate((self.csrc,) + self.include_dirs):
            for f in sorted(d.iterdir()):
                h.update(f"\0{i}\0{f.name}\0".encode() + f.read_bytes())
        return BUILD_ROOT / h.hexdigest()[:16] / f"lib{self.name}.so"

    def build_log(self) -> str:
        """The compiler's output of the last build (ptxas register and
        shared-memory lines included)."""
        return (self.library_path().parent / "build.log").read_text()

    def build(self) -> Path:
        """Compile the library unless it exists; returns its path. The
        compiler's output is kept beside it in ``build.log``."""
        lib = self.library_path()
        if lib.is_file():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build or a
        # build cut short never leaves a partial library under the final
        # name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, *(f"-I{d}" for d in self.include_dirs),
               "-o", tmp, *map(str, self.sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (lib.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}) "
                               f"building {self.csrc}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
        return lib

    def load(self) -> ctypes.CDLL:
        """Build if needed, load once, and declare the signatures."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self.declare(lib)
                self._lib = lib
            return self._lib


__all__ = ["BUILD_ROOT", "COMMON", "NVCC_FLAGS", "nvcc", "CudaLibrary"]
