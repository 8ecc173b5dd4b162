"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled with
nvcc for sm_90a into `build/torch_kernels/<name>-<hash>.so` at the repository
root (the hash covers the source and the flags, so an edit rebuilds) and loaded
with ctypes. Nothing is compiled when a module is imported.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is not built yet, and load it."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                                      capture_output=True, text=True)
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]
