"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one or more ``.cu`` sources inside this package,
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
with a plain C interface and loaded with ``ctypes``. Nothing builds at
import time: a library builds at its first use (:meth:`CudaLibrary.load`).
The output goes to ``_build/`` beside this file, named by a digest of the
sources, the headers they include and the flags, so an edited source
never loads a stale binary.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:meth:`CudaLibrary.check` raises on a nonzero code (a refused launch
never runs, and a later synchronize would not report it). Each kernel
of a library is a :class:`CudaKernel`, which counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["BUILD_DIR", "CudaKernel", "CudaLibrary", "NVCC_FLAGS",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
#: ``-fno-gnu-unique``: a template function's static (a launcher's granted
#: shared memory, from a header compiled into several libraries) stays
#: each library's own instead of one GNU unique symbol for the process
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xcompiler",
              "-fno-gnu-unique", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build from source at first use")


class CudaLibrary:
    """One kernel library: its sources, the package headers they
    include, and its C functions (each returning an ``int`` CUDA error
    code)."""

    def __init__(self, name: str, sources: Sequence[str],
                 functions: Dict[str, list], headers: Sequence[str] = ()):
        self.name = name
        self.sources = tuple(_PKG / s for s in sources)
        self.headers = tuple(_PKG / s for s in headers)
        self.functions = dict(functions)
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources + self.headers:
            h.update(src.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _build(self) -> None:
        """Run nvcc unless the library is already built."""
        out = self.path
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, self.sources)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {self.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
        self.build_log = proc.stdout

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not yet."""
        with self._lock:
            if self._lib is None:
                self._build()
                lib = ctypes.CDLL(str(self.path))
                for sym, argtypes in self.functions.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
                lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def check(self, symbol: str, code: int) -> None:
        """Raise on a nonzero CUDA error code from ``symbol``."""
        if code:
            msg = self._lib.dl4j_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name}.{symbol}: CUDA error {code} "
                               f"({msg})")


class CudaKernel:
    """One kernel of a :class:`CudaLibrary`: its C entry point for each
    dtype and a plain integer count of its launches, bumped by
    :meth:`launch` once the launch went through."""

    def __init__(self, library: CudaLibrary, name: str,
                 symbols: Dict[object, str]):
        self.library = library
        self.name = name
        self.symbols = dict(symbols)
        self.launches = 0

    def launch(self, dtype, *args) -> None:
        """Call the entry point for ``dtype`` with ``args`` (pointers,
        sizes, the stream), raise on a nonzero CUDA error code, count
        the launch."""
        lib = self.library.load()
        sym = self.symbols[dtype]
        self.library.check(sym, getattr(lib, sym)(*args))
        self.launches += 1
