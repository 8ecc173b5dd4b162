"""Exponential moving average of a model's weights and BatchNorm statistics
(port of yolo_dual_tpu/train/ema.py; reference utils/torch_utils.py:404-432)."""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn


class ModelEMA:
    """`ema` is a frozen copy of the model. Each `update(model)` blends every
    floating-point parameter and buffer of `model` (BatchNorm running stats
    included) into it with decay(t) = decay · (1 − e^{−t/tau}), t the number of
    updates so far, computed in float32 as in JAX; integer buffers
    (`num_batches_tracked`) are copied."""

    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.decay, self.tau, self.updates = decay, tau, 0
        sd = self.ema.state_dict()
        self._keys = [k for k, v in sd.items() if v.is_floating_point()]
        self._float = [sd[k] for k in self._keys]
        self._other = {k: v for k, v in sd.items() if not v.is_floating_point()}

    @torch.no_grad()
    def update(self, model: nn.Module):
        self.updates += 1
        d = np.float32(self.decay) * (np.float32(1) - np.exp(-np.float32(self.updates)
                                                             / np.float32(self.tau)))
        msd = model.state_dict()
        torch._foreach_mul_(self._float, float(d))
        torch._foreach_add_(self._float, [msd[k] for k in self._keys], alpha=float(np.float32(1) - d))
        for k, v in self._other.items():
            v.copy_(msd[k])

    def state_dict(self) -> dict:
        return {"model": self.ema.state_dict(), "updates": self.updates}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        self.ema.load_state_dict(sd["model"])
        self.updates = int(sd["updates"])
