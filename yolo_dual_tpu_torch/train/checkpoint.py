"""Training checkpoints as torch `.pt` files (port of
yolo_dual_tpu/train/checkpoint.py; reference segment/train.py:574-577,
utils/general.py:1004-1018 strip_optimizer, utils/torch_utils.py:361-378
smart_resume).

A checkpoint is a dict in the reference's layout: `model` (the trained
model's state_dict), `ema` (the EMA model's state_dict) and `updates` (its
update count), `optimizer` (SmartOptimizer.state_dict), `epoch`,
`best_fitness`, and `data_rng`, the training dataset's random state after
that epoch, so that a resumed run draws the samples the uninterrupted run
would. Every value is a tensor, a number, a string, a list, a tuple or a
dict of those: checkpoints load with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

from yolo_dual_tpu_torch.io import ocdbt
from yolo_dual_tpu_torch.io.weights import state_dict_from_orbax
from yolo_dual_tpu_torch.utils.general import LOGGER, intersect_dicts


def save_checkpoint(path, state_dict: dict) -> Path:
    """Write the checkpoint dict `state_dict` to `path` through a temporary
    file, so a run killed while saving leaves the previous checkpoint whole."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state_dict, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def load_weights(model: torch.nn.Module, state_dict: dict) -> torch.nn.Module:
    """Load the entries of `state_dict` whose name and shape match `model`'s,
    leave the others (the non-strict import of JAX segment/train.py:117-124:
    another class count, BatchNorm counters a JAX export lacks). Raises when
    nothing matches: that is a wrong file, never a partial load."""
    own = model.state_dict()
    take = intersect_dicts(state_dict, own)
    if state_dict and not take:
        raise ValueError(f"weights match no entry of the model (first keys: {list(state_dict)[:5]})")
    missing = len(own) - len(take)
    unmatched = len(state_dict) - len(take)
    if missing or unmatched:
        LOGGER.info(f"weights: loaded {len(take)} of {len(own)} entries, {missing} missing, "
                    f"{unmatched} unmatched source keys")
    with torch.no_grad():
        for k, v in take.items():
            own[k].copy_(v)
    return model


def partial_load(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load the shape-matching entries of a checkpoint into `model`,
    preferring its EMA weights (JAX checkpoint.py:49): a `.pt` of the port or
    a state_dict, or an orbax checkpoint directory of the JAX package, whose
    source is JAX's: `ckpt["ema"]["ema"]` where the EMA is not empty, else
    `variables`, else the bare tree."""
    if not str(path).endswith(".pt"):
        return load_weights(model, state_dict_from_orbax(path))
    ckpt = load_checkpoint(path)
    src = ckpt.get("ema") or ckpt.get("model") or ckpt
    return load_weights(model, src)


def strip_optimizer(path, out: Optional[str] = None):
    """Keep only the EMA weights, as `model`: drop the optimizer state and the
    EMA, epoch -1 (JAX checkpoint.py:75; reference utils/general.py:1004).
    An orbax checkpoint directory of the JAX package (any path not ending in
    .pt) is rewritten as JAX's strip_optimizer rewrites it: `variables` <-
    `ema["ema"]` (or the whole `ema`) where `ema` is not None, `opt_state` and
    `ema` None, `epoch` -1, written to `out` or in place (io/ocdbt.py)."""
    if not str(path).endswith(".pt"):
        tree = ocdbt.load_checkpoint(path)
        if tree.get("ema") is not None:
            tree["variables"] = tree["ema"]["ema"] if "ema" in tree["ema"] else tree["ema"]
        tree.update(opt_state=None, ema=None, epoch=-1)
        ocdbt.save_checkpoint(out or path, tree)
        LOGGER.info(f"Optimizer stripped from {path}")
        return
    ckpt = load_checkpoint(path)
    if ckpt.get("ema") is not None:
        ckpt["model"] = ckpt["ema"]
    ckpt.update(ema=None, updates=None, optimizer=None, epoch=-1)
    save_checkpoint(out or path, ckpt)
    LOGGER.info(f"Optimizer stripped from {path}")


# opt keys a resumed run takes from the invocation, never from the run's opt.json
NOT_RESTORED = ("resume", "device", "workers", "project", "name", "exist_ok", "explicit")


def resume_run(opt):
    """--resume, as the JAX CLIs resolve it (segment/train.py:62-99,
    semantic/train.py:81-111): the run directory and its checkpoint (the
    given checkpoint file, or the newest run under project/name* with a
    last.pt), the run's settings put back on `opt` from its opt.json with the
    flags typed on this command line (`opt.explicit`) winning. Returns (run
    directory, checkpoint, the run's hyp.json as a dict, or None where --hyp
    was typed or the run has none)."""
    if isinstance(opt.resume, str) and Path(opt.resume).is_file():
        ckpt = Path(opt.resume)
        save_dir = ckpt.parent
    else:
        runs = sorted((p for p in Path(opt.project).glob(f"{opt.name}*")
                       if (p / "last.pt").exists()),
                      key=lambda p: (p / "last.pt").stat().st_mtime)
        if not runs:
            raise FileNotFoundError(f"--resume: no run with a last.pt under "
                                    f"{opt.project}/{opt.name}*")
        save_dir, ckpt = runs[-1], runs[-1] / "last.pt"
    explicit = set(getattr(opt, "explicit", []) or [])
    if (save_dir / "opt.json").exists():
        for k, v in json.loads((save_dir / "opt.json").read_text()).items():
            if k not in NOT_RESTORED and k not in explicit and hasattr(opt, k):
                setattr(opt, k, v)
    hyp_file = save_dir / "hyp.json"
    hyp = json.loads(hyp_file.read_text()) if hyp_file.exists() and "hyp" not in explicit else None
    return save_dir, ckpt, hyp
