"""Core conv modules, NCHW (port of yolo_dual_tpu/nn/common.py).

Attribute names follow the reference torch modules (`conv`, `bn`, `cv1`, `m.0`,
...), so a reference-style state_dict loads with `strict=True`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.nn.activations import resolve_act

# The detection/segment profile: eps 1e-3, torch momentum 0.03 (flax 0.97),
# reference utils/torch_utils.py:217-219.
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None, d: int = 1):
    """Torch-style 'same' padding: p = k // 2 (per spatial dim), dilation-aware."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else [d * (x - 1) + 1 for x in k]
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


def fuse_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """Fold `bn` into a new conv with bias (reference utils/torch_utils.py
    fuse_conv_and_bn; JAX models/model.py:fuse_conv_bn)."""
    fused = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
                      conv.padding, conv.dilation, conv.groups, bias=True,
                      device=conv.weight.device, dtype=conv.weight.dtype)
    with torch.no_grad():
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        fused.weight.copy_(conv.weight * scale[:, None, None, None])
        bias = bn.bias - bn.running_mean * scale
        if conv.bias is not None:
            bias = bias + conv.bias * scale
        fused.bias.copy_(bias)
    return fused


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose training forward updates `running_var` with the biased
    batch variance, as flax's BatchNorm does (JAX nn/common.py:210-244);
    torch's own feeds in the unbiased one. The normalised output, the
    gradients, the running mean and the state_dict keys are torch's."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        # momentum 1 makes F.batch_norm write the batch mean and unbiased variance
        # into these scratch buffers, so no second pass over x is needed
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m * (n - 1) / n)
        return y


class Conv(nn.Module):
    """Conv2d + BN + act (reference models/common.py:47-64). After `fuse()` the
    BN is folded into the conv and `bn` is None. The BN keeps JAX's running
    variance in training (`BatchNorm2d`)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = resolve_act(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)

    def fuse(self):
        if self.bn is not None:
            self.conv = fuse_conv_bn(self.conv, self.bn)
            self.bn = None
        return self


class Bottleneck(nn.Module):
    """Standard residual bottleneck (reference models/common.py:115-125)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (reference models/common.py:161-172)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c1, c_, 1, 1, act=act)
        self.cv3 = Conv(2 * c_, c2, 1, act=act)
        self.m = nn.Sequential(*self.inner(c_, n, shortcut, g, act))

    def inner(self, c_, n, shortcut, g, act):
        """The inner bottlenecks; the override point of C3 variants (JAX C3.inner)."""
        return [Bottleneck(c_, c_, shortcut, g, e=1.0, act=act) for _ in range(n)]

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """SPP-Fast: 3 chained k×k stride-1 max pools (reference models/common.py:223-238).
    `F.max_pool2d` pads with -inf, as the JAX `max_pool_same` does."""

    def __init__(self, c1, c2, k=5, act=True):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, act=act)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Concat(nn.Module):
    """Concatenate a list of tensors along dimension `d` (1 = channels)."""

    def __init__(self, d=1):
        super().__init__()
        self.d = d

    def forward(self, xs):
        return torch.cat(xs, self.d)


class Upsample(nn.Module):
    """nn.Upsample equivalent for the rows the supported configs use: nearest
    with an integer factor, which is an exact repeat."""

    def __init__(self, size=None, scale_factor=2.0, mode="nearest"):
        super().__init__()
        if mode != "nearest" or size is not None or scale_factor is None \
                or not float(scale_factor).is_integer():
            raise NotImplementedError(
                f"Upsample(size={size}, scale_factor={scale_factor}, mode={mode!r}): "
                "only integer-factor nearest upsampling is ported")
        self.scale_factor = int(scale_factor)

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale_factor, mode="nearest")


class Proto(nn.Module):
    """Mask prototype head for Segment (reference models/common.py:838-848).
    Output (b, c2, 2h, 2w)."""

    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = Conv(c1, c_, k=3)
        self.cv2 = Conv(c_, c_, k=3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        x = F.interpolate(self.cv1(x), scale_factor=2, mode="nearest")
        return self.cv3(self.cv2(x))
