"""General utilities: logging, config and dataset loading, seeding, device
selection, timers.

Port of the parts of yolo_dual_tpu/utils/general.py that the port uses
(make_divisible, check_img_size, LOGGER, Profile, increment_path, init_seeds,
check_dataset, labels_to_class_weights, labels_to_image_weights), plus a config loader that reads the package's JSON config
copies without PyYAML; run settings are saved as JSON for the same reason.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import random
import time
from pathlib import Path

import numpy as np
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


# The folders of the package's JSON copies, in find_cfg's search order.
CONFIG_DIRS = ("segment", "semantic", "hyps", "models", "hub", "spp", "attention", "backbone",
               "loss")


def find_cfg(name) -> Path:
    """Resolve a config name: an existing path, else the package's JSON copy of
    that model or hyperparameter config (`yolov5s-seg.yaml` and
    `yolov5s-seg.json` both find configs/segment/yolov5s-seg.json;
    `hyp.scratch-low.yaml` finds configs/hyps/hyp.scratch-low.json;
    `yolov3-tiny.yaml` finds configs/hub/yolov3-tiny.json). A name qualified
    by its folder under configs/, as the JAX package names its configs
    (`backbone/resnet18.yaml`, `semantic/resnet50.json`), finds that folder's
    copy; a bare stem is searched in the order of CONFIG_DIRS. Two stems are
    shared, resnet18 and resnet50 (semantic/ and backbone/): bare, they find
    the semantic configs, so `resnet50.yaml` is the semantic flagship."""
    p = Path(name)
    if p.exists():
        return p
    if len(p.parts) == 2 and p.parts[0] in CONFIG_DIRS:
        cands = [CONFIGS / p.parts[0] / (p.stem + ".json")]
    else:
        cands = [CONFIGS / sub / (p.stem + ".json") for sub in CONFIG_DIRS]
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(f"config {name} not found (nor {' nor '.join(map(str, cands))})")


def json_save(file, data: dict):
    """Save a flat settings dict (opt, hyp) as JSON; paths become strings."""
    Path(file).write_text(json.dumps({k: (str(v) if isinstance(v, Path) else v)
                                      for k, v in data.items()}, indent=1))


def init_seeds(seed: int = 0):
    """Seed Python's, numpy's and torch's global generators (JAX
    utils/general.py:74; the datasets and models draw from their own seeded
    generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def check_dataset(data, require_splits: bool = True) -> dict:
    """Resolve a dataset: a directory, or a JSON (YAML with PyYAML) data file
    with the data yaml's keys `path`, `train`, `val`, `nc`, `names` (JAX
    utils/general.py:143, local only: a `download` hook is never run).

    A directory holds `images/` (`.npy` frames) and `labels/` (txt labels),
    split into `images/train` and `images/val` when both exist, else one set
    for both splits; its classes are the model config's (nc None). Returns
    {"train", "val", "nc", "names"} with the paths resolved; raises when the
    val path is missing, unless `require_splits` is False (a predictor takes
    only names and nc)."""
    p = Path(data)
    if p.is_dir():
        im = p / "images" if (p / "images").is_dir() else p
        split = (im / "train").is_dir() and (im / "val").is_dir()
        d = {"train": str(im / "train" if split else im), "val": str(im / "val" if split else im),
             "nc": None, "names": None}
    else:
        d = dict(load_config(p))
        for k in ("train", "val", "test"):
            if d.get(k):
                vals = d[k] if isinstance(d[k], list) else [d[k]]
                root = Path(d["path"]) if d.get("path") else p.parent
                resolved = [str(root / v) for v in vals]
                d[k] = resolved if isinstance(d[k], list) else resolved[0]
        if isinstance(d.get("names"), list):
            d["names"] = dict(enumerate(d["names"]))
        if d.get("names") is not None:
            d["names"] = {int(k): v for k, v in d["names"].items()}
        d.setdefault("nc", len(d["names"]) if d.get("names") else None)
    val = d.get("val")
    missing = [v for v in (val if isinstance(val, list) else [val]) if not v or not Path(v).exists()]
    if missing and require_splits:
        raise FileNotFoundError(f"dataset {data}: val path not found: {missing} "
                                "(nothing is downloaded)")
    return d


def labels_to_class_weights(labels, nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights of the training labels (each an
    (n, 5+) array of [cls, xywh...]), summing to 1; uniform without labels
    (JAX utils/general.py:199-209; reference utils/general.py:714-731)."""
    if len(labels) == 0 or labels[0] is None:
        return np.ones(nc, np.float32) / nc
    classes = np.concatenate([np.asarray(lb)[:, 0] for lb in labels], 0).astype(int)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    return (weights / weights.sum()).astype(np.float32)


def labels_to_image_weights(labels, nc: int = 80, class_weights=None) -> np.ndarray:
    """Each image's sampling weight: the sum of its instances' class weights
    (JAX utils/general.py:212-220; reference utils/general.py:733-738), for
    --image-weights."""
    cw = np.ones(nc, np.float32) if class_weights is None else np.asarray(class_weights)
    counts = np.stack([np.bincount(np.asarray(lb)[:, 0].astype(int), minlength=nc)
                       if len(lb) else np.zeros(nc) for lb in labels])
    return (cw.reshape(1, nc) * counts).sum(1)


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
