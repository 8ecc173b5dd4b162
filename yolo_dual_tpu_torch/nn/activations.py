"""Activation registry (port of yolo_dual_tpu/nn/activations.py).

Resolves the model-config `activation:` spellings to torch modules.
"""

from __future__ import annotations

import torch.nn as nn

# Names accepted in model-config `activation:` keys, both the short names and
# the reference's `nn.XYZ()` spellings.
ACTIVATIONS = {
    "silu": nn.SiLU,
    "relu": nn.ReLU,
    "leaky_relu": lambda: nn.LeakyReLU(0.1),
    "leakyrelu": lambda: nn.LeakyReLU(0.1),
    "hardswish": nn.Hardswish,
    "mish": nn.Mish,
    "sigmoid": nn.Sigmoid,
    "identity": nn.Identity,
    "none": nn.Identity,
    "nn.silu()": nn.SiLU,
    "nn.relu()": nn.ReLU,
    "nn.leakyrelu(0.1)": lambda: nn.LeakyReLU(0.1),
    "nn.hardswish()": nn.Hardswish,
}


def resolve_act(act) -> nn.Module:
    """Resolve an activation spec (True/False/None/str/nn.Module) to a module.

    True -> SiLU, False/None -> identity, str -> registry lookup.
    """
    if act is True:
        return nn.SiLU()
    if act is False or act is None:
        return nn.Identity()
    if isinstance(act, nn.Module):
        return act
    key = str(act).strip().lower()
    if key in ACTIVATIONS:
        return ACTIVATIONS[key]()
    raise KeyError(f"Unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
