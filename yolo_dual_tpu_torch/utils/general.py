"""General utilities: logging, config loading, device selection, timers.

Port of the parts of yolo_dual_tpu/utils/general.py that the prediction slice
uses (make_divisible, check_img_size, LOGGER, Profile, increment_path), plus a
config loader that reads the package's JSON config copies without PyYAML.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import time
from pathlib import Path

import torch

FRAMEWORK_NAME = "yolo_dual_tpu_torch"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def set_logging(name: str = FRAMEWORK_NAME, verbose: bool = True):
    level = logging.INFO if verbose else logging.ERROR
    log = logging.getLogger(name)
    log.setLevel(level)
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        handler.setLevel(level)
        log.addHandler(handler)
    log.propagate = False
    return log


LOGGER = set_logging()


def make_divisible(x, divisor: int = 8) -> int:
    """Round channel count up to the nearest multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


def check_img_size(imgsz, s: int = 32, floor: int = 0):
    """Verify image size is a multiple of the max stride `s` (per dimension)."""
    if isinstance(imgsz, int):
        new_size = max(make_divisible(imgsz, int(s)), floor)
    else:
        imgsz = list(imgsz)
        new_size = [max(make_divisible(x, int(s)), floor) for x in imgsz]
    if new_size != imgsz:
        LOGGER.warning(f"WARNING: --img-size {imgsz} must be multiple of max stride {s}, updating to {new_size}")
    return new_size


def load_config(path) -> dict:
    """Read a model config: JSON always, YAML when PyYAML is importable."""
    path = Path(path)
    if path.suffix == ".json":
        return json.loads(path.read_text())
    if path.suffix in (".yaml", ".yml"):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"{path} is YAML but PyYAML is not installed; use the JSON "
                              f"copies under {CONFIGS}") from e
        with open(path, errors="ignore") as f:
            return yaml.safe_load(f)
    raise ValueError(f"unsupported config type {path.suffix!r} ({path}); expected .json or .yaml")


def find_cfg(name) -> Path:
    """Resolve a config name: an existing path, else the package's JSON copy of
    that model or hyperparameter config (`yolov5s-seg.yaml` and
    `yolov5s-seg.json` both find configs/segment/yolov5s-seg.json;
    `hyp.scratch-low.yaml` finds configs/hyps/hyp.scratch-low.json)."""
    p = Path(name)
    if p.exists():
        return p
    cands = [CONFIGS / sub / (p.stem + ".json") for sub in ("segment", "hyps")]
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(f"config {name} not found (nor {' nor '.join(map(str, cands))})")


def select_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... (reference utils/general.py:1094)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                break
        path = Path(p)
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


class Profile(contextlib.ContextDecorator):
    """Accumulating wall-clock timer. On a CUDA device it synchronizes on entry
    and exit, so `dt` includes the device work queued inside the block
    (reference utils/general.py:165-183)."""

    def __init__(self, t: float = 0.0, device=None):
        self.t = t
        self.dt = 0.0
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        self._sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()
