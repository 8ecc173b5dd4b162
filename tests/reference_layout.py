"""Checkpoints in the reference's own layouts, written from a model of the port,
for the port's tests and chip_smoke.py: what a user of the reference hands
the port. No JAX here.

- `reference_state_dict` renames the port's state_dict as the reference's
  trainers name it: the semantic trainers' `backbone.{i}` / `head.{j}` roots
  (reference seg_jaccardloss_Resnet50.py:355-356), a ResNetStem's
  `stem.0` for its conv, a VGGBlock's `block.{n}` for its `conv{n}`, a
  ResNet layer's downsample registered a second time at the layer's level,
  a TransformerLayer's nn.MultiheadAttention `ma` with its joint
  `in_proj_weight` / `in_proj_bias`, and a Detect head's `anchors` buffer.
- `write_reference_tree` writes a stand-in for the reference's source tree:
  a module whose class holds those names, as the reference's nn.Modules do.
- `save_pickled_module` saves a half-precision module of that class in the
  reference trainers' container (`{'model': ema.half(), ...}`, reference
  seg_diceloss_Resnet50.py:1193-1200), then takes the tree off sys.path and
  sys.modules, so reading the file needs the tree again.
"""

from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path

import torch

STUB = "reference_stub"  # the stand-in tree's module
STUB_SOURCE = '''"""Stand-in for the reference's module classes: children and tensors under
the reference's names."""
import torch.nn as nn

BUFFERS = ("running_mean", "running_var", "num_batches_tracked", "anchors")


class ReferenceModule(nn.Module):
    pass


def from_state_dict(state_dict):
    root = ReferenceModule()
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        m = root
        for p in path:
            if p not in m._modules:
                m.add_module(p, ReferenceModule())
            m = m._modules[p]
        if leaf in BUFFERS:
            m.register_buffer(leaf, v.clone())
        else:
            m.register_parameter(leaf, nn.Parameter(v.clone(), requires_grad=False))
    return root
'''


def reference_state_dict(sd: dict, spec, semantic_roots: bool = True) -> dict:
    """The port's state_dict `sd` of a model compiled to `spec`, under the
    reference's names (module docstring). `semantic_roots` roots the rows at
    `backbone.` / `head.`; else they stay `model.{i}`, as the reference's
    YOLO models keep them."""
    out = {}
    nb = spec.n_backbone
    for k, v in sd.items():
        m = re.fullmatch(r"model\.(\d+)\.(.*)", k)
        i, rest = int(m.group(1)), m.group(2)
        name = spec.layers[i].name
        if name == "ResNetStem":
            rest = re.sub(r"^conv\.", "stem.0.", rest)
        elif name == "VGGBlock":
            rest = re.sub(r"^conv(\d+)\.", r"block.\1.", rest)
        tr = re.fullmatch(r"(.*\.tr\.\d+\.)(in_q|in_k|in_v|out_proj)\.(weight|bias)", rest)
        if tr:
            rest = f"{tr.group(1)}ma.{tr.group(2)}.{tr.group(3)}"
        if semantic_roots:
            root = f"backbone.{i}" if i < nb else f"head.{i - nb}"
        else:
            root = f"model.{i}"
        out[f"{root}.{rest}"] = v.detach().clone()
        if name == "ResNetLayer" and rest.startswith("layer.0.downsample."):
            out[f"{root}.{rest.removeprefix('layer.0.')}"] = v.detach().clone()
    for prefix in sorted({k.rsplit(".ma.", 1)[0] for k in out if ".ma.in_q." in k}):
        for leaf in ("weight", "bias"):
            out[f"{prefix}.ma.in_proj_{leaf}"] = torch.cat(
                [out.pop(f"{prefix}.ma.{p}.{leaf}") for p in ("in_q", "in_k", "in_v")])
    head = spec.layers[-1]
    if head.name in ("Detect", "Segment"):
        root = f"model.{head.i}" if not semantic_roots else f"head.{head.i - nb}"
        anchors = torch.tensor(head.kw()["anchors"], dtype=torch.float32)
        out[f"{root}.anchors"] = anchors.view(len(anchors), -1, 2)
    return out


def write_reference_tree(root) -> Path:
    """Write the stand-in reference tree under `root`; returns `root`."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / f"{STUB}.py").write_text(STUB_SOURCE)
    return root


def save_pickled_module(path, state_dict: dict, root) -> Path:
    """Save `state_dict` as a half-precision module of the stand-in tree at
    `root`, in the reference trainers' container, then forget the tree."""
    sys.path.insert(0, str(root))
    try:
        stub = importlib.import_module(STUB)
        module = stub.from_state_dict(state_dict).half()
        torch.save({"epoch": 29, "best_fitness": 0.5, "model": module, "ema": None,
                    "updates": None, "optimizer": None}, path)
    finally:
        forget_reference_tree(root)
    return Path(path)


def forget_reference_tree(root):
    """Take the stand-in tree off sys.path and out of sys.modules."""
    while str(root) in sys.path:
        sys.path.remove(str(root))
    sys.modules.pop(STUB, None)
