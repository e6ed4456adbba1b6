"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``csrc/`` has a plain C interface.  :func:`build` compiles it
for ``sm_90a`` into a shared library under ``_build/`` inside this package
(git-ignored), named by a digest of the source and the flags, so an
unchanged source is compiled once.  :class:`CudaLibrary` loads a library at
its first use and declares its functions' ``argtypes``; nothing is built or
loaded when a module is imported.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; set CUDA_HOME")
    return str(path)


def build(source: Path) -> dict:
    """Compile ``source`` (once per source and flag set) and return
    ``{"path", "seconds", "log", "cached"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` register and shared-memory summary."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return {"path": out, "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log, "cached": False}


class CudaLibrary:
    """The shared library of one CUDA source, built and loaded at first use.

    ``signatures`` maps each exported function to its ``argtypes``; every
    function returns an ``int`` CUDA error code (0 on success)."""

    def __init__(self, source: Path, signatures: dict):
        self.source = source
        self.signatures = signatures
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> dict:
        return build(self.source)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()["path"]))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib
