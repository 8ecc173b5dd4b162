"""General utilities: logging, config and dataset loading, seeding, device
selection, timers.

Port of yolo_dual_tpu/utils/general.py (make_divisible, check_img_size,
LOGGER, colorstr, Profile, increment_path, init_seeds, yaml_load, yaml_save,
check_dataset, labels_to_class_weights, labels_to_image_weights,
intersect_dicts, platform_info, clean_str), plus a config loader that reads
the package's JSON config copies without PyYAML; run settings are saved as JSON for the
same reason, and PyYAML is imported only where a YAML file is read or
written.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import platform
import random
import re
import subprocess
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


def colorstr(*input):
    """colorstr('blue', 'hello world') -> an ANSI-coloured string (reference
    utils/general.py:148); one argument is coloured blue and bold."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
        "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m", "bright_green": "\033[92m",
        "bright_yellow": "\033[93m", "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


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
            return yaml_load(path)
        except ImportError as e:
            raise ImportError(f"{path} is YAML but PyYAML is not installed; use the JSON "
                              f"copies under {CONFIGS}") from e
    raise ValueError(f"unsupported config type {path.suffix!r} ({path}); expected .json or .yaml")


# The folders of the package's JSON copies, in find_cfg's search order.
CONFIG_DIRS = ("segment", "semantic", "hyps", "models", "hub", "spp", "attention", "backbone",
               "loss", "data")


def find_cfg(name, *dirs) -> Path:
    """Resolve a config name: an existing path, else the package's JSON copy of
    that model, hyperparameter or data config (`yolov5s-seg.yaml` and
    `yolov5s-seg.json` both find configs/segment/yolov5s-seg.json;
    `hyp.scratch-low.yaml` finds configs/hyps/hyp.scratch-low.json;
    `coco128-seg.yaml` finds configs/data/coco128-seg.json). A name qualified
    by its folder under configs/, as the JAX package names its configs
    (`backbone/resnet18.yaml`, `semantic/resnet50.json`), finds that folder's
    copy; a bare stem is searched in `dirs`, as the JAX CLIs' find_cfg(name,
    *dirs) searches them (`find_cfg(data, "data")` finds no model config),
    or without `dirs` in the order of CONFIG_DIRS. Two stems are shared,
    resnet18 and resnet50 (semantic/ and backbone/): bare, they find the
    semantic configs, so `resnet50.yaml` is the semantic flagship."""
    p = Path(name)
    if p.exists():
        return p
    if len(p.parts) == 2 and p.parts[0] in CONFIG_DIRS:
        cands = [CONFIGS / p.parts[0] / (p.stem + ".json")]
    else:
        cands = [CONFIGS / sub / (p.stem + ".json") for sub in (dirs or CONFIG_DIRS)]
    for c in cands:
        if c.exists():
            return c
    raise FileNotFoundError(f"config {name} not found (nor {' nor '.join(map(str, cands))})")


def yaml_load(file) -> dict:
    """A YAML file's contents (PyYAML's safe_load; imported here, since the
    package runs without it)."""
    import yaml
    with open(file, errors="ignore") as f:
        return yaml.safe_load(f)


def yaml_save(file, data: dict):
    """Write a flat dict as YAML in its own key order; paths become strings."""
    import yaml
    with open(file, "w") as f:
        yaml.safe_dump({k: (str(v) if isinstance(v, Path) else v) for k, v in data.items()}, f,
                       sort_keys=False)


def json_save(file, data: dict):
    """Save a flat settings dict (opt, hyp) as JSON; paths become strings."""
    Path(file).write_text(json.dumps({k: (str(v) if isinstance(v, Path) else v)
                                      for k, v in data.items()}, indent=1))


def init_seeds(seed: int = 0, deterministic: bool = False):
    """Seed Python's, numpy's and torch's global generators (JAX
    utils/general.py:74; the datasets and models draw from their own seeded
    generators). `deterministic` is torch's counterpart of JAX's XLA flag
    `--xla_gpu_deterministic_ops`: deterministic algorithms only, cuDNN
    deterministic and not benchmarking, and cuBLAS's workspace set as
    deterministic cuBLAS needs it where the environment does not set it."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return seed


def check_dataset(data, autodownload: bool = True, require_splits: bool = True) -> dict:
    """Resolve a dataset (JAX utils/general.py:143): a data file (JSON, or YAML
    with PyYAML) or dict with the data yaml's keys `path`, `train`, `val`,
    `test`, `nc`, `names` and `download`, or a directory.

    For a data file the dict is JAX's: each split joined to `path` when the
    file has one, else kept as written (relative to the working directory);
    `names` a dict of int ids; `nc` len(names) where the file has no `nc`.
    When a named val path is missing (an absent or empty `val` names none)
    and `require_splits` is set, the file's `download:` hook runs where
    `autodownload` is on, as JAX runs it after logging its first 500
    characters: a `bash ...` line in the shell, any other text that is not
    a URL as Python with the dict bound as `yaml`; a URL is refused, since
    the port downloads nothing. The val paths are checked again after the
    hook. Without a hook, or with `autodownload` off, it raises
    FileNotFoundError.

    A directory holds `images/` (`.npy` frames) and `labels/` (txt labels),
    split into `images/train` and `images/val` when both exist, else one set
    for both splits; its classes are the model config's (nc None)."""
    if isinstance(data, (str, Path)) and Path(data).is_dir():
        im = Path(data) / "images" if (Path(data) / "images").is_dir() else Path(data)
        split = (im / "train").is_dir() and (im / "val").is_dir()
        return {"train": str(im / "train" if split else im),
                "val": str(im / "val" if split else im), "nc": None, "names": None}
    d = dict(load_config(data)) if isinstance(data, (str, Path)) else data
    for k in ("train", "val", "test"):
        if d.get(k):
            vals = d[k] if isinstance(d[k], list) else [d[k]]
            resolved = [str(Path(d["path"]) / v) if d.get("path") else str(v) for v in vals]
            d[k] = resolved if isinstance(d[k], list) else resolved[0]
    if isinstance(d.get("names"), list):
        d["names"] = dict(enumerate(d["names"]))
    if isinstance(d.get("names"), dict):  # JSON keys are strings
        d["names"] = {int(k): v for k, v in d["names"].items()}
    d.setdefault("nc", len(d.get("names") or {}))

    val, hook = d.get("val"), d.get("download")
    val_paths = [Path(v) for v in (val if isinstance(val, list) else [val])] if val else []
    if require_splits and val_paths and not all(v.exists() for v in val_paths):
        missing = [str(v) for v in val_paths if not v.exists()]
        if not (hook and autodownload):
            raise FileNotFoundError(
                f"Dataset val path not found: {missing}"
                + ("" if hook else " (no download: hook in the data yaml)")
                + ("" if autodownload else " (autodownload disabled)"))
        LOGGER.warning(
            f"Dataset val path missing ({missing}); executing the data yaml's download hook "
            f"(pass autodownload=False / --no-download to refuse):\n{str(hook)[:500]}")
        t0 = time.time()
        if isinstance(hook, str) and hook.startswith("http"):
            raise FileNotFoundError(f"Dataset val path not found: {missing}; the download hook "
                                    f"is a URL ({hook}) and the port downloads nothing: fetch "
                                    "the data yourself")
        if isinstance(hook, str) and hook.startswith("bash "):
            subprocess.run(hook, shell=True, check=True)
        else:  # inline Python, with the resolved dict in scope as JAX's
            exec(hook, {"yaml": d, "Path": Path})
        ok = all(v.exists() for v in val_paths)
        LOGGER.info(f"Dataset download hook {'succeeded' if ok else 'FAILED'} "
                    f"({time.time() - t0:.1f}s)")
        if not ok:
            raise FileNotFoundError(f"download hook ran but val path still missing: {d['val']}")
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


def intersect_dicts(da: dict, db: dict, exclude=()) -> dict:
    """The entries of `da` whose key is in `db` with the same shape (np.shape,
    so tensors, arrays and nested lists alike) and contains none of the
    `exclude` strings (JAX utils/general.py:221)."""
    return {k: v for k, v in da.items()
            if k in db and all(x not in k for x in exclude)
            and tuple(np.shape(v)) == tuple(np.shape(db[k]))}


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


def platform_info() -> str:
    """One line naming the Python, torch and CUDA versions and the visible cards."""
    return (f"python {platform.python_version()} torch {torch.__version__} cuda "
            f"{torch.version.cuda} devices {torch.cuda.device_count()}")


def clean_str(s: str) -> str:
    """`s` with the characters the reference replaces in file names made `_`."""
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


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
