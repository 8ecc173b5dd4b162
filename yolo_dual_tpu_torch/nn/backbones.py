"""Backbone stages and the shared head of the semantic graphs, NCHW (port of
yolo_dual_tpu/nn/backbones.py; reference unet-lite/Resnet50/seg_diceloss_Resnet50.py
ResNetStem/BottleneckBlock/ResNet50Layer, unet-lite/Resnet18 BasicBlock and
the segment head, unet-lite/Vgg16 VGGBlock).

Child names follow the JAX modules (`conv`, `pool`, `conv1..3`, `downsample`,
`lateral{i}`, `final0/1`, `conv{i}`), except a ResNet stage's blocks, which
are `layer.{i}` as in the reference and in JAX's torch export
(train/checkpoint.py:122-128, `block{i}` -> `layer.{i}`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.nn.activations import resolve_act
from yolo_dual_tpu_torch.nn.common import Conv


class ResNetStem(nn.Module):
    """7x7/2 conv + 3x3/2 max pool."""

    def __init__(self, c1, c2=64, act="relu"):
        super().__init__()
        self.conv = Conv(c1, c2, 7, 2, 3, act=act)
        self.pool = nn.MaxPool2d(3, 2, 1)  # pads with -inf, as flax's max_pool

    def forward(self, x):
        return self.pool(self.conv(x))


class BasicBlock(nn.Module):
    """ResNet18/34 residual block; the projection where the stride or the
    width changes."""

    def __init__(self, c1, c2, stride=1, act="relu"):
        super().__init__()
        self.conv1 = Conv(c1, c2, 3, stride, 1, act=act)
        self.conv2 = Conv(c2, c2, 3, 1, 1, act=False)
        self.downsample = Conv(c1, c2, 1, stride, 0, act=False) \
            if stride != 1 or c1 != c2 else None
        self.act = resolve_act(act)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return self.act((x if self.downsample is None else self.downsample(x)) + y)


class BottleneckBlock(nn.Module):
    """ResNet50 bottleneck, 4x channel expansion."""

    def __init__(self, c1, mid, stride=1, act="relu"):
        super().__init__()
        c2 = mid * 4
        self.conv1 = Conv(c1, mid, 1, 1, 0, act=act)
        self.conv2 = Conv(mid, mid, 3, stride, 1, act=act)
        self.conv3 = Conv(mid, c2, 1, 1, 0, act=False)
        self.downsample = Conv(c1, c2, 1, stride, 0, act=False) \
            if stride != 1 or c1 != c2 else None
        self.act = resolve_act(act)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return self.act((x if self.downsample is None else self.downsample(x)) + y)


class ResNetLayer(nn.Module):
    """A ResNet stage of `n` blocks, the first carrying the stride:
    block="bottleneck" is ResNet50Layer, "basic" ResNet18Layer/ResNet34Layer.
    Config args [c2, n, stride]."""

    def __init__(self, c1, c2, n=1, stride=1, block="bottleneck", act="relu"):
        super().__init__()
        if block == "bottleneck":
            blocks = [BottleneckBlock(c1 if i == 0 else c2, c2 // 4, stride if i == 0 else 1, act)
                      for i in range(n)]
        elif block == "basic":
            blocks = [BasicBlock(c1 if i == 0 else c2, c2, stride if i == 0 else 1, act)
                      for i in range(n)]
        else:
            raise ValueError(f"ResNetLayer block {block!r}: expected 'bottleneck' or 'basic'")
        self.layer = nn.Sequential(*blocks)

    def forward(self, x):
        return self.layer(x)


def resize_bilinear_ac(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NCHW tensor, no
    antialias (JAX backbones.py:118, which SegmentHead uses)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class SegmentHead(nn.Module):
    """U-Net-style semantic head: a lateral 1x1 Conv per input scale, each
    resized (align_corners=True) to the first input's size, concatenated,
    then a 3x3 and a 1x1 Conv. `c1` is the tuple of input channels."""

    def __init__(self, c1, nc=12, width=128, act="relu"):
        super().__init__()
        for i, c in enumerate(c1):
            self.add_module(f"lateral{i}", Conv(c, width, 1, 1, act=act))
        self.final0 = Conv(width * len(c1), 2 * width, 3, 1, act=act)
        self.final1 = Conv(2 * width, nc, 1, 1, act=False)

    def forward(self, feats):
        target = feats[0].shape[-2:]
        ys = [resize_bilinear_ac(getattr(self, f"lateral{i}")(f), target)
              for i, f in enumerate(feats)]
        return self.final1(self.final0(torch.cat(ys, 1)))


class VGGBlock(nn.Module):
    """`n` 3x3 Convs, then a 2x2/2 max pool when `pool`."""

    def __init__(self, c1, c2, n=2, pool=True, act="relu"):
        super().__init__()
        for i in range(n):
            self.add_module(f"conv{i}", Conv(c1 if i == 0 else c2, c2, 3, 1, act=act))
        self.n = n
        self.pool = nn.MaxPool2d(2, 2, 0) if pool else None

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv{i}")(x)
        return x if self.pool is None else self.pool(x)
