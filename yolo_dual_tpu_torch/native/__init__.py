"""The native JSON mask scanner (port of yolo_dual_tpu/native/__init__.py).

`fastmask.cpp` is built at first use with JAX's g++ line (no pybind11: the
plain CPython C API) into `build/native/` at the repository root, never beside
the source, and loaded from there. Where it cannot be built or loaded the
masks are parsed with `json`, as JAX falls back, and a log line says so. This
is host code: the card's path does not depend on it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER

SRC = Path(__file__).resolve().parent / "fastmask.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SO = BUILD_DIR / f"fastmask{sysconfig.get_config_var('EXT_SUFFIX') or '.so'}"

_STATE: dict = {}  # "module": the loaded extension, or None once it failed
_LOCK = threading.Lock()


def _build() -> bool:
    """Compile fastmask.cpp unless SO is newer; through a temporary file, so a
    concurrent build never loads a partial library."""
    if SO.exists() and SO.stat().st_mtime >= SRC.stat().st_mtime:
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", str(SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, SO)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        LOGGER.info(f"native fastmask build skipped ({e}); using the json fallback")
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The fastmask extension, built and loaded at the first call; None where
    it could not be (then masks are parsed with `json`)."""
    if "module" in _STATE:
        return _STATE["module"]
    with _LOCK:
        if "module" not in _STATE:
            mod = None
            if _build():
                try:
                    spec = importlib.util.spec_from_file_location("fastmask", SO)
                    mod = importlib.util.module_from_spec(spec)
                    spec.loader.exec_module(mod)
                except (ImportError, OSError) as e:
                    LOGGER.info(f"native fastmask load failed ({e}); using the json fallback")
                    mod = None
            _STATE["module"] = mod
    return _STATE["module"]


def parse_mask_json_bytes(data: bytes) -> np.ndarray:
    """The (h, w) uint8 mask of a JSON dense-mask record: by the native
    scanner where it loaded, else by `json`; a record the scanner refuses
    is parsed by `json` too (JAX json_dataset.py:75-82)."""
    mod = load()
    if mod is not None:
        try:
            h, w, raw = mod.parse_mask_json(data)
            return np.frombuffer(raw, np.uint8).reshape(h, w)
        except ValueError:
            pass
    d = json.loads(data)
    return np.asarray(d["mask_data"], np.uint8).reshape(d["shape"])
