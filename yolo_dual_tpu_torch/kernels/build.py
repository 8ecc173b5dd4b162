"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled with
nvcc for sm_90a into `build/torch_kernels/<name>-<hash>.so` at the repository
root (the hash covers the source, the csrc/ headers it includes and the flags,
so an edit to any of them rebuilds) and loaded
with ctypes. Nothing is compiled when a module is imported. Kernels of
different names may be built at the same time from several threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_LOCKS: dict = {}  # one lock per kernel name, so different kernels build in parallel
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


def _sources(path: Path, seen: list) -> list:
    """`path` and, depth first, every csrc/ file it includes with #include "…"."""
    if path not in seen:
        seen.append(path)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            _sources(path.parent / inc, seen)
    return seen


def library_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in _sources(CSRC / f"{name}.cu", []))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is not built yet, and load it."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
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
