"""The spatial-pyramid-pooling zoo of the `spp/` configs, NCHW (port of
yolo_dual_tpu/nn/spp.py; reference models/common.py:1275-1498): SimConv and
SimSPPF (YOLOv6), ASPP, BasicConv and RFB, SPPCSPC and SPPCSPC_group
(YOLOv7), SimCSPSPPF (YOLOv6 v0.3). Child names are the JAX modules'.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.nn.common import BatchNorm2d, Conv, max_pool_same, resize_bilinear


class SimConv(Conv):
    """Conv + BN + ReLU (JAX nn/spp.py:22)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act="relu", bn=True, bias=False):
        super().__init__(c1, c2, k, s, p, g, d, act, bn, bias)


class SimSPPF(nn.Module):
    """SPPF with SimConvs (JAX nn/spp.py:28)."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = SimConv(c1, c_, 1, 1)
        self.cv2 = SimConv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class ASPP(nn.Module):
    """Atrous SPP of raw convolutions with bias and no BatchNorm (JAX
    nn/spp.py:45): an image-pool branch (the mean over the map, a 1x1 conv,
    resized bilinearly back to the map's size), a 1x1 branch and 3x3 branches
    at dilations 6, 12 and 18, each padded by its rate, then a 1x1 `out`."""

    RATES = (6, 12, 18)

    def __init__(self, c1, c2=256):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 1)
        self.atrous1 = nn.Conv2d(c1, c2, 1)
        for r in self.RATES:
            setattr(self, f"atrous{r}", nn.Conv2d(c1, c2, 3, padding=r, dilation=r))
        self.out = nn.Conv2d(c2 * (2 + len(self.RATES)), c2, 1)

    def forward(self, x):
        img = resize_bilinear(self.conv(x.mean((2, 3), keepdim=True)), x.shape[-2:])
        branches = [img, self.atrous1(x)] + [getattr(self, f"atrous{r}")(x) for r in self.RATES]
        return self.out(torch.cat(branches, 1))


class FixedProfileBatchNorm2d(BatchNorm2d):
    """A BatchNorm that keeps the eps and momentum it was built with: the
    graph's BatchNorm profile (models/model.py:GraphModel) passes it by."""


class BasicConv(nn.Module):
    """Conv with an optional BatchNorm of its own profile, eps 1e-5 and torch
    momentum 0.01 (flax's 0.99), and an optional ReLU (JAX nn/spp.py:66). The
    conv has a bias only without the BatchNorm. `fuse()` of the graph folds
    only `Conv`, so BasicConv keeps its BatchNorm: fused or not, its forward
    is the same."""

    def __init__(self, c1, c2, k=1, s=1, p=0, d=1, g=1, relu=True, bn=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, p, dilation=d, groups=g, bias=not bn)
        self.bn = FixedProfileBatchNorm2d(c2, eps=1e-5, momentum=0.01) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class RFB(nn.Module):
    """Receptive-field block (JAX nn/spp.py:95): three branches of BasicConvs
    with dilations vision + 1, + 2 and + 4, a 1x1 `linear` over them, a 1x1
    `shortcut`, and relu(linear · scale + shortcut)."""

    def __init__(self, c1, c2, stride=1, scale=0.1, map_reduce=8, vision=1, groups=1):
        super().__init__()
        ip, g, v, s = c1 // map_reduce, groups, vision, stride
        self.scale = scale
        self.b0_0 = BasicConv(c1, ip, 1, 1, g=g, relu=False)
        self.b0_1 = BasicConv(ip, 2 * ip, 3, s, 1, g=g)
        self.b0_2 = BasicConv(2 * ip, 2 * ip, 3, 1, v + 1, d=v + 1, g=g, relu=False)
        self.b1_0 = BasicConv(c1, ip, 1, 1, g=g, relu=False)
        self.b1_1 = BasicConv(ip, 2 * ip, 3, s, 1, g=g)
        self.b1_2 = BasicConv(2 * ip, 2 * ip, 3, 1, v + 2, d=v + 2, g=g, relu=False)
        self.b2_0 = BasicConv(c1, ip, 1, 1, g=g, relu=False)
        self.b2_1 = BasicConv(ip, (ip // 2) * 3, 3, 1, 1, g=g)
        self.b2_2 = BasicConv((ip // 2) * 3, 2 * ip, 3, s, 1, g=g)
        self.b2_3 = BasicConv(2 * ip, 2 * ip, 3, 1, v + 4, d=v + 4, g=g, relu=False)
        self.linear = BasicConv(6 * ip, c2, 1, 1, relu=False)
        self.shortcut = BasicConv(c1, c2, 1, s, relu=False)

    def forward(self, x):
        b0 = self.b0_2(self.b0_1(self.b0_0(x)))
        b1 = self.b1_2(self.b1_1(self.b1_0(x)))
        b2 = self.b2_3(self.b2_2(self.b2_1(self.b2_0(x))))
        out = self.linear(torch.cat([b0, b1, b2], 1))
        return F.relu(out * self.scale + self.shortcut(x))


class SPPCSPC(nn.Module):
    """YOLOv7's CSP SPP (JAX nn/spp.py:131): every Conv grouped by `groups`
    (default 1; SPPCSPC_group: 4); `n`, `shortcut` and `g` are accepted and
    unused, as in JAX."""

    groups = 1

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5, k=(5, 9, 13), groups=None):
        super().__init__()
        c_, g = int(2 * c2 * e), self.groups if groups is None else groups
        self.cv1 = Conv(c1, c_, 1, 1, g=g)
        self.cv3 = Conv(c_, c_, 3, 1, g=g)
        self.cv4 = Conv(c_, c_, 1, 1, g=g)
        self.cv5 = Conv(c_ * (len(k) + 1), c_, 1, 1, g=g)
        self.cv6 = Conv(c_, c_, 3, 1, g=g)
        self.cv2 = Conv(c1, c_, 1, 1, g=g)
        self.cv7 = Conv(2 * c_, c2, 1, 1, g=g)
        self.k = tuple(k)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(torch.cat([x1] + [max_pool_same(x1, k) for k in self.k], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))


class SPPCSPC_group(SPPCSPC):
    groups = 4


class SimCSPSPPF(nn.Module):
    """YOLOv6 v0.3's CSP SPPF (JAX nn/spp.py:161): SPPCSPC's shape with three
    chained k x k pools; its Convs are SiLU Convs, as JAX's are."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5, k=5):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c_, 3, 1)
        self.cv4 = Conv(c_, c_, 1, 1)
        self.cv5 = Conv(4 * c_, c_, 1, 1)
        self.cv6 = Conv(c_, c_, 3, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv7 = Conv(2 * c_, c2, 1, 1)
        self.k = k

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        x2 = max_pool_same(x1, self.k)
        x3 = max_pool_same(x2, self.k)
        x4 = max_pool_same(x3, self.k)
        y1 = self.cv6(self.cv5(torch.cat([x1, x2, x3, x4], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))
