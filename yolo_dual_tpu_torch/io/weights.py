"""Carry weights into the port's modules.

`resolve_state_dict` is the one rule every loader follows (JAX
io/weights.py:12 resolve_variables): a `.pt` file is a torch state_dict, and
anything else is an orbax checkpoint directory that the JAX package wrote,
read by `io/ocdbt.py` without JAX. `state_dict_from_flax` maps the JAX
package's variables to the port's state_dict; it is this package's own copy
of the mapping in yolo_dual_tpu/train/checkpoint.py:92-143
(export_torch_state_dict).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.io.ocdbt import OrbaxCheckpoint


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


# Buffers of the reference torch Detect that the port derives from the config.
_DERIVED = ("anchors", "anchor_grid")


def _port_names(sd: dict) -> dict:
    """A reference-style or JAX-exported state_dict under the port's names.
    The reference's TransformerLayer keeps its attention in an
    nn.MultiheadAttention `ma`, whose joint `in_proj_weight` / `in_proj_bias`
    (q, k, v stacked on the output axis) become the Linears `in_q`, `in_k`,
    `in_v`, and whose `ma.out_proj` becomes `out_proj`, as JAX's torch import
    splits them (io/torch_import.py:160-210); JAX's export names C3TR's block
    `m_tr` and C3SPP's `m_spp`, the port and the reference `m`."""
    out = {}
    for k, v in sd.items():
        for inner in _FLAX_INNER:
            k = k.replace(f".{inner}.", ".m.")
        head, sep, leaf = k.rpartition(".ma.")
        if not sep:
            out[k] = v
        elif leaf in ("in_proj_weight", "in_proj_bias"):
            for name, part in zip(("in_q", "in_k", "in_v"), v.chunk(3, 0)):
                out[f"{head}.{name}.{leaf.removeprefix('in_proj_')}"] = part.clone()
        else:
            out[f"{head}.{leaf}"] = v
    return out


def load_state_dict_file(path) -> dict:
    """Read a reference-style torch state_dict file (a plain dict of tensors, or one
    under an "ema", "model", "model_state_dict" or "state_dict" key, in that
    order, as JAX's io/torch_import.py:load_torch_checkpoint unwraps them)
    with `torch.load(weights_only=True)`, under the port's names
    (`_port_names`)."""
    path = Path(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("ema", "model", "model_state_dict", "state_dict"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not hold a state_dict")
    return _port_names({k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] not in _DERIVED})


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
    return _port_names(state_dict_from_flax(orbax_variables(path, prefer_ema)))


def resolve_state_dict(weights) -> dict:
    """The state_dict of a weights path under the port's names (JAX
    io/weights.py:12 resolve_variables): a `.pt` file through
    `load_state_dict_file`, anything else as an orbax checkpoint directory
    (`state_dict_from_orbax`, the EMA first). Load it with
    `model.load_state_dict(..., strict=True)`."""
    if str(weights).endswith(".pt"):
        return load_state_dict_file(weights)
    return state_dict_from_orbax(weights)
