"""Carry weights into the port's modules.

`resolve_state_dict` is the one rule every loader follows (JAX
io/weights.py:12 resolve_variables): a `.pt` file is a torch checkpoint,
read and translated by `io/torch_import.py` as JAX's torch import reads it,
and anything else is an orbax checkpoint directory that the JAX package
wrote, read by `io/ocdbt.py` without JAX. `state_dict_from_flax` maps the JAX
package's variables to the port's state_dict; it is this package's own copy
of the mapping in yolo_dual_tpu/train/checkpoint.py:92-143
(export_torch_state_dict).
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

from yolo_dual_tpu_torch.io.ocdbt import OrbaxCheckpoint
from yolo_dual_tpu_torch.io.torch_import import (load_torch_checkpoint, missing_entries,
                                                 port_state_dict, translate_state_dict)


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


# The JAX tree's numbered children -> the torch lists they belong to.
_FLAX_LISTS = {"m_": "m", "tr_": "tr", "block": "layer"}
# JAX's names of the one inner block of C3TR and C3SPP; the reference's is `m`.
_FLAX_INNER = ("m_tr", "m_spp")


def state_dict_from_flax(variables) -> dict:
    """JAX `{"params", "batch_stats"}` tree (nested dicts of arrays) -> torch
    state_dict with the reference's names and layouts:

    - `model_{i}` -> `model.{i}`, `model_{i}_{r}` -> `model.{i}.{r}`, `m_{j}` -> `m.{j}`,
      a TransformerBlock's `tr_{j}` -> `tr.{j}`, a ResNet stage's `block{j}` ->
      `layer.{j}` (JAX train/checkpoint.py:122-128), and C3TR's `m_tr` and
      C3SPP's `m_spp` -> `m`, the reference's name of their inner block;
    - the Segment head's `detect` level is dropped (the torch Segment subclasses Detect);
    - conv `kernel` HWIO -> `weight` OIHW; Dense `kernel` (in, out) ->
      Linear `weight` (out, in); BN `scale` -> `weight`; the raw deformable
      weights (DCNv2's `weight`, C2f_DCN's `m_{i}_dcn_weight`) HWIO -> OIHW
      under their own names; the attention blocks' `rel_h`, `rel_w`, `emb_a`,
      `emb_b`, `emb_mix` as they are; `mean`/`var` -> `running_mean`/`running_var`;
    - every BatchNorm gets the `num_batches_tracked` buffer the JAX tree lacks.
    """
    out = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            v = np.asarray(v)
            segs = list(path)
            m = re.fullmatch(r"model_(\d+)(?:_(\d+))?", segs[0])
            if m:
                segs[0] = f"model.{m.group(1)}" + (f".{m.group(2)}" if m.group(2) else "")
            if len(segs) > 2 and segs[1] == "detect":
                segs.pop(1)
            new = []
            for s in segs[:-1]:
                mm = re.fullmatch(r"(m_|tr_|block)(\d+)", s)
                if mm:
                    s = f"{_FLAX_LISTS[mm.group(1)]}.{mm.group(2)}"
                new.append("m" if s in _FLAX_INNER else s)
            leaf = segs[-1]
            if coll == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
                if leaf == "running_mean":
                    out[".".join(new + ["num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
            elif leaf == "kernel":
                leaf = "weight"
                if v.ndim == 4:
                    v = v.transpose(3, 2, 0, 1)
                elif v.ndim == 2:
                    v = v.T
            elif leaf == "scale":
                leaf = "weight"
            elif (leaf == "weight" or leaf.endswith("_dcn_weight")) and v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            out[".".join(new + [leaf])] = torch.from_numpy(np.array(v, copy=True))
    return out


def load_state_dict_file(path) -> dict:
    """A `.pt` checkpoint of the port's layout or a YOLO one of the
    reference under the port's names: the weights that
    `io/torch_import.py:load_torch_checkpoint` unwraps (a state_dict, or one
    under "ema", "model", "model_state_dict" or "state_dict", in JAX's order),
    each key translated by JAX's rules (`port_state_dict`). Keys JAX skips are
    left out; nothing is checked against a model. The `backbone.` / `head.`
    roots of the reference semantic trainers need the model's rows and raise
    here: read such a file with `resolve_state_dict(path, model)`."""
    return {name: v for _, name, v in port_state_dict(load_torch_checkpoint(path))}


def orbax_variables(path, prefer_ema: bool = True):
    """The flax variables tree of the orbax checkpoint at `path`, by JAX's
    rule (io/weights.py:12): `ckpt["ema"]["ema"]` where the EMA is there and
    not empty, else `ckpt["variables"]`, else the bare tree (a checkpoint
    that is itself a variables tree). `prefer_ema=False` skips the EMA, as
    JAX's segment/train.py:120-125 --weights does. Only the chosen subtree is
    decoded: never the optimizer state."""
    ckpt = OrbaxCheckpoint(path)
    if prefer_ema and ckpt.has("ema") and ckpt.has("ema/ema"):
        return ckpt.read("ema/ema")
    return ckpt.read("variables" if ckpt.contains("variables") else "")


def state_dict_from_orbax(path, prefer_ema: bool = True) -> dict:
    """`orbax_variables(path, prefer_ema)` as a state_dict under the port's
    names."""
    return state_dict_from_flax(orbax_variables(path, prefer_ema))


def resolve_state_dict(weights, model=None) -> dict:
    """The state_dict of a weights path under the port's names (JAX
    io/weights.py:12 resolve_variables). A `.pt` file goes through JAX's
    torch import rules: given the `model` it is for, a whole state_dict of
    the model filled from the file where its entries match by name and shape
    (`io/torch_import.py:translate_state_dict`, strict=False), the file's
    other keys skipped; where the file leaves entries unfilled, they hold
    JAX's fresh `model.init()` (PRNGKey(0) and the Detect bias prior:
    `models/flax_init.py:flax_init_` on a copy of the model), as JAX's fill
    of a fresh init does. A file that fills nothing raises ValueError.
    Without a `model`, the file's entries under the port's names
    (`load_state_dict_file`). A file that pickles the reference's modules
    needs the reference tree on sys.path, as JAX's CLIs do. Anything else is
    an orbax checkpoint directory (`state_dict_from_orbax`, the EMA first).
    Load it with `model.load_state_dict(..., strict=True)`."""
    if str(weights).endswith(".pt"):
        if model is None:
            return load_state_dict_file(weights)
        from yolo_dual_tpu_torch.models.flax_init import flax_init_
        sd = load_torch_checkpoint(weights)
        if missing_entries(model, sd):
            model = flax_init_(copy.deepcopy(model), 0)
        return translate_state_dict(model, sd, strict=False)
    return state_dict_from_orbax(weights)
