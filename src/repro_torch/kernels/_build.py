"""Build and load the port's CUDA C++ kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, from the sources in the checkout, into ``build/kernels/`` at
the root of the repository; the library's file name carries a digest of the
source and the flags, so an edited source is rebuilt and never mixed up
with an old build. Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are built on a machine with the CUDA "
                           "toolkit")
    return path


class CudaLibrary:
    """One ``.cu`` source, its shared library and its C entry points.

    ``symbols`` maps each exported C function to its ``ctypes`` argument
    types; every entry point returns an ``int`` (a ``cudaError_t``)."""

    def __init__(self, source: Path, symbols: Dict[str, List]):
        self.source = Path(source)
        self.symbols = symbols
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_s: Optional[float] = None   # seconds nvcc took, if built
        self.build_log = ""                    # nvcc's -Xptxas -v report

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def compile_command(self, out: Path) -> List[str]:
        return [nvcc_path()] + NVCC_FLAGS + ["-o", str(out), str(self.source)]

    def build(self) -> Path:
        """Run nvcc for this source unless its library is already built."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run(self.compile_command(tmp),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        self.build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)      # atomic against a parallel build
        return out

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.symbols.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib
