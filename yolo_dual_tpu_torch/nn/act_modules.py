"""Activations with parameters (port of yolo_dual_tpu/nn/act_modules.py;
reference utils/activations.py:45-103): FReLU, AconC and MetaAconC. JAX
registers none of them with its compiler, and neither does the port; they
are built directly. Their `p1`, `p2` are the reference's (1, c, 1, 1),
where JAX's are NHWC (1, 1, 1, c).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.nn.common import BatchNorm2d


class FReLU(nn.Module):
    """Funnel ReLU, max(x, BN(depthwise k x k conv of x)) (JAX
    act_modules.py:21): its BatchNorm takes eps 1e-5 and torch momentum 0.1
    (flax 0.9)."""

    def __init__(self, c1, k=3):
        super().__init__()
        self.conv = nn.Conv2d(c1, c1, k, 1, k // 2, groups=c1, bias=False)
        self.bn = BatchNorm2d(c1, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return torch.maximum(x, self.bn(self.conv(x)))


class AconC(nn.Module):
    """ACON-C, (p1 − p2)·x·σ(β·(p1 − p2)·x) + p2·x with learned p1, p2 and β
    (JAX act_modules.py:38)."""

    def __init__(self, c1):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.beta = nn.Parameter(torch.ones(1, c1, 1, 1))

    def forward(self, x):
        dpx = (self.p1 - self.p2) * x
        return dpx * torch.sigmoid(self.beta * dpx) + self.p2 * x


class MetaAconC(nn.Module):
    """Meta-ACON: ACON-C whose β is σ(fc2(fc1(the spatial mean of x))), per
    sample, fc1 to max(r, c1 // r) channels (JAX act_modules.py:54)."""

    def __init__(self, c1, r=16):
        super().__init__()
        c2 = max(r, c1 // r)
        self.p1 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.p2 = nn.Parameter(torch.randn(1, c1, 1, 1))
        self.fc1 = nn.Conv2d(c1, c2, 1, 1, bias=True)
        self.fc2 = nn.Conv2d(c2, c1, 1, 1, bias=True)

    def forward(self, x):
        beta = torch.sigmoid(self.fc2(self.fc1(x.mean((2, 3), keepdim=True))))
        dpx = (self.p1 - self.p2) * x
        return dpx * torch.sigmoid(beta * dpx) + self.p2 * x
