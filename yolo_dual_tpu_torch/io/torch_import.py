"""Reference `.pt` checkpoints into the port's modules (port of
yolo_dual_tpu/io/torch_import.py).

The reference and the port both name weights the torch way (`model.{i}.…`,
`m.{j}`, a ResNet stage's `layer.{k}`, OIHW convolutions), so most keys pass
as they are. The translation covers what differs, by JAX's rules
(io/torch_import.py:54-132):

- the reference semantic trainers root their keys at `backbone.{i}` and
  `head.{j}` (reference seg_jaccardloss_Resnet50.py:355-356); `head.{j}` is
  row `n_backbone + j` of the compiled graph (`ModelSpec.n_backbone`);
- the reference ResNetStem wraps its Conv and pool in `stem.{0,1}`: `stem.0`
  is the port's `conv`; a reference VGGBlock's `block.{n}` is the port's
  `conv{n}`;
- `num_batches_tracked`, `anchors`, `anchor_grid` and `stride` are skipped:
  the model keeps its own (the heads derive theirs from the config);
- an nn.MultiheadAttention `ma`'s joint `in_proj_weight` / `in_proj_bias`
  split into the Linears `in_q`, `in_k`, `in_v`, and its `ma.out_proj` is
  `out_proj` (JAX :160-210); the names JAX's export gives C3TR's and
  C3SPP's inner block, `m_tr` and `m_spp`, become `m`;
- a reference ResNet layer registers its `downsample` twice; a copy that
  matches no entry of the model is skipped.

`load_torch_checkpoint` reads the file, `import_torch_state_dict` fills a
model with it, strictly by default, and raises when nothing matches.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

from yolo_dual_tpu_torch.utils.general import LOGGER

SKIP_SUFFIXES = ("num_batches_tracked", "anchors", "anchor_grid", "stride")
# The containers a checkpoint may wrap its weights in, in the order JAX
# unwraps them (io/torch_import.py:259-266).
CONTAINER_KEYS = ("ema", "model", "model_state_dict", "state_dict")


def translate_torch_key(key: str, n_backbone: int = 0):
    """The port's name of the torch state_dict key `key`, or None for a key
    JAX skips. `n_backbone` is the rows of the config's `backbone:` section,
    which a `head.{j}` root is offset by. JAX's version also takes the head's
    row and kind, for its Segment tree, which nests Detect's convolutions
    under `detect`; the port's Segment keeps them at its own level, as the
    reference does, so no key needs them."""
    if key.endswith(SKIP_SUFFIXES):
        return None
    parts = key.split(".")
    if parts[0] in ("backbone", "head") and len(parts) > 2 and parts[1].isdigit():
        idx = int(parts[1]) + (n_backbone if parts[0] == "head" else 0)
        parts = ["model", str(idx)] + parts[2:]
    head, rest, leaf = parts[:2], parts[2:-1], parts[-1]
    segs, i = [], 0
    while i < len(rest):
        s, nxt = rest[i], rest[i + 1] if i + 1 < len(rest) else ""
        if s in ("m", "tr", "layer") and nxt.isdigit():  # torch lists, as the port's
            segs += [s, nxt]
            i += 2
        elif s == "stem" and nxt == "0":  # ResNetStem: stem.0 = Conv, stem.1 = pool
            segs.append("conv")
            i += 2
        elif s == "block" and nxt.isdigit():  # VGGBlock: convolutions, then the pool
            segs.append(f"conv{nxt}")
            i += 2
        else:
            segs.append("m" if s in ("m_tr", "m_spp") else s)
            i += 1
    return ".".join(head + segs + [leaf])


def _tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))


def port_state_dict(state_dict: dict, spec=None):
    """Yield (source key, port key, tensor) for each entry of a torch
    state_dict under the port's names (`translate_torch_key`, with `spec`'s
    `n_backbone`), a joint attention projection as its three parts; skipped
    keys yield nothing. Raises ValueError on `backbone.` / `head.` roots
    without the `spec` that places them, and where two source keys name one
    entry: neither may silently overwrite a row."""
    n_backbone = spec.n_backbone if spec is not None else 0
    seen = {}

    def named(key, name, v):
        if name in seen:
            raise ValueError(f"torch import: {seen[name]!r} and {key!r} both translate to {name!r}")
        seen[name] = key
        return key, name, v

    for key, v in state_dict.items():
        if spec is None and key.split(".", 1)[0] in ("backbone", "head"):
            raise ValueError(f"torch import: {key!r} is rooted at a reference semantic "
                             "trainer's backbone./head.; its row needs the model it is for "
                             "(resolve_state_dict(path, model))")
        v = _tensor(v)
        head, sep, leaf = key.rpartition(".ma.")
        if sep and leaf in ("in_proj_weight", "in_proj_bias"):
            base = translate_torch_key(f"{head}.ma", n_backbone).removesuffix(".ma")
            for name, part in zip(("in_q", "in_k", "in_v"), v.chunk(3, 0)):
                yield named(key, f"{base}.{name}.{leaf.removeprefix('in_proj_')}", part.clone())
            continue
        name = translate_torch_key(f"{head}.{leaf}" if sep else key, n_backbone)  # ma.out_proj
        if name is not None:
            yield named(key, name, v)


def _match(model: torch.nn.Module, state_dict: dict):
    """(the model's state_dict, its entries the file fills, the file's keys
    that fill none, the model's entries no key fills) by JAX's rules."""
    own = model.state_dict()
    take, unmatched = {}, []
    for key, name, v in port_state_dict(state_dict, getattr(model, "spec", None)):
        if name not in own:
            # the reference's ResNet layers register their downsample twice
            if ".downsample." in key and not key.startswith("layer"):
                continue
            unmatched.append(key)
        elif own[name].shape != v.shape:
            unmatched.append(f"{key} (shape {tuple(v.shape)} vs {tuple(own[name].shape)})")
        else:
            take[name] = v.to(own[name].dtype)
    missing = [k for k in own if k not in take and not k.endswith(SKIP_SUFFIXES)]
    return own, take, unmatched, missing


def missing_entries(model: torch.nn.Module, state_dict: dict) -> list:
    """The entries of `model` that the torch `state_dict` leaves unfilled
    (`translate_state_dict`'s missing ones)."""
    return _match(model, state_dict)[3]


def translate_state_dict(model: torch.nn.Module, state_dict: dict, strict: bool = True,
                         verbose: bool = False) -> dict:
    """The whole state_dict of `model` with the entries of the torch
    `state_dict` (reference or JAX-exported layout) in place of its own,
    by JAX's rules (io/torch_import.py:135-239): a source key whose name or
    shape matches no entry is unmatched (a duplicate ResNet `downsample`
    is skipped), an entry of the model that no key fills is missing, leaving
    aside the buffers JAX skips. `strict` raises ValueError on either; a
    file that fills nothing raises whatever `strict` says. The counts are
    logged where an entry is missing or a key unmatched, or with `verbose`."""
    own, take, unmatched, missing = _match(model, state_dict)
    if verbose or unmatched or missing:
        LOGGER.info(f"torch import: filled {len(take)} entries, {len(missing)} missing, "
                    f"{len(unmatched)} unmatched source keys")
    if strict and (unmatched or missing):
        detail = [f"missing {k}" for k in missing[:10]] + [f"unmatched {k}" for k in unmatched[:10]]
        raise ValueError("strict torch import failed:\n  " + "\n  ".join(detail))
    if state_dict and not take:
        # a file that matches nothing is a wrong file or an unknown layout, never
        # an intended partial load
        raise ValueError("torch import matched 0 entries: the checkpoint layout does not "
                         f"correspond to this model (first source keys: {list(state_dict)[:5]})")
    return {**own, **take}


def import_torch_state_dict(model: torch.nn.Module, state_dict: dict,
                            strict: bool = True, verbose: bool = False) -> torch.nn.Module:
    """Fill `model` with a torch state_dict (`translate_state_dict`); the
    entries a non-strict import leaves missing keep their values. `verbose`
    logs the counts, as JAX's."""
    model.load_state_dict(translate_state_dict(model, state_dict, strict, verbose), strict=True)
    return model


def load_torch_checkpoint(path, reference_root=None) -> dict:
    """A `.pt` checkpoint as a plain {name: tensor} state_dict. The file is
    read with `torch.load(weights_only=True)`; only where torch refuses it
    because it pickles whole modules, as the reference trainers save
    (`{'model': ema.half(), ...}`, reference seg_diceloss_Resnet50.py:1193-1200),
    is it read as JAX reads it (io/torch_import.py:242): `weights_only=False`,
    with `reference_root` (the reference source tree its classes come from)
    on sys.path. Only open such files from a source you trust: unpickling
    runs their code. The weights are unwrapped from the first of "ema",
    "model", "model_state_dict", "state_dict" that is not None, a module's
    through `.float().state_dict()`. Raises ValueError for a payload that
    holds no tensors or anything but tensors."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if "weights_only" not in str(e):  # a damaged file, not a pickled object
            raise
        if reference_root is not None and str(reference_root) not in sys.path:
            sys.path.insert(0, str(reference_root))
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    payload = ckpt
    if isinstance(ckpt, dict):
        for key in CONTAINER_KEYS:
            if ckpt.get(key) is not None:
                payload = ckpt[key]
                break
    if isinstance(payload, torch.nn.Module):
        payload = payload.float().state_dict()
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: unsupported checkpoint payload {type(payload).__name__}")
    bad = [k for k, v in payload.items() if not (torch.is_tensor(v) or isinstance(v, np.ndarray))]
    if not payload or bad:
        raise ValueError(f"{path} does not hold a state_dict: "
                         + (f"entries {bad[:5]} are not tensors" if bad else "it is empty"))
    return {k: _tensor(v) for k, v in payload.items()}
