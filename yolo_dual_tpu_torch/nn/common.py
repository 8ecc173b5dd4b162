"""Core conv modules, NCHW (port of yolo_dual_tpu/nn/common.py).

Attribute names follow the reference torch modules (`conv`, `bn`, `cv1`, `m.0`,
...), so a reference-style state_dict loads with `strict=True`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.nn.activations import resolve_act
from yolo_dual_tpu_torch.parallel import spatial

# BatchNorm profiles (eps, torch momentum) of the reference's two paths (JAX
# nn/common.py:37-45): the detection/segment models' initialize_weights sets
# eps 1e-3, momentum 0.03 (flax 0.97; reference utils/torch_utils.py:217-219);
# the semantic scripts keep torch's defaults. A compiled spec picks its
# profile (models/compiler.py:ModelSpec.bn_profile); modules are built with
# the detect one and GraphModel sets the other on its own BatchNorms.
BN_EPS = 1e-3
BN_MOMENTUM = 0.03
SEMANTIC_BN_EPS = 1e-5
SEMANTIC_BN_MOMENTUM = 0.1


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
    gradients, the running mean and the state_dict keys are torch's. With
    `update_stats` False a training forward normalises by the batch
    statistics as it does and leaves the running statistics and the batch
    count alone (the recomputed forward of a rematerialised step,
    train/trainer.py). With `mesh` set (parallel/mesh.py:convert_sync_batchnorm)
    the training statistics cover every rank's batch: flax's E[x²] − E[x]² of
    the all-reduced per-channel sums, differentiable through the all-reduce."""

    update_stats = True
    mesh = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        update = self.update_stats
        if update:
            self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        if self.mesh is not None:
            return self._forward_sync(x, m, update)
        n = x.numel() // x.shape[1]
        if n == 1:
            # one value a channel (GAM's pooled maps at batch 1): F.batch_norm refuses
            # it; flax normalises with the batch mean and a variance of 0, so the
            # output is the bias and the running variance decays toward 0
            mean = x.mean((0, 2, 3))
            y = (x - mean[:, None, None]) * torch.rsqrt(torch.full_like(mean, self.eps))[
                :, None, None] * self.weight[:, None, None] + self.bias[:, None, None]
            if update:
                with torch.no_grad():
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m)
            return y
        # momentum 1 makes F.batch_norm write the batch mean and unbiased variance
        # into these scratch buffers, so no second pass over x is needed
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        if update:
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m * (n - 1) / n)
        return y

    def _forward_sync(self, x, m: float, update: bool):
        from yolo_dual_tpu_torch.parallel.mesh import all_reduce_sum
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                             xf.new_full((x.shape[1],), x.numel() // x.shape[1])])
        tot = all_reduce_sum(local)
        n = tot[2]
        mean = tot[0] / n
        var = (tot[1] / n - mean * mean).clamp(min=0.0)
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        if update:
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1 - m).add_(var.to(self.running_var.dtype), alpha=m)
        return y.to(x.dtype)


class Conv(nn.Module):
    """Conv2d + BN + act (reference models/common.py:47-64). After `fuse()` the
    BN is folded into the conv and `bn` is None. The BN keeps JAX's running
    variance in training (`BatchNorm2d`). Inside parallel/spatial.py:spatial
    the conv runs on the rank's band with its halo rows (`spatial.conv2d`)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = resolve_act(act)

    def forward(self, x):
        x = spatial.conv2d(x, self.conv) if spatial.space_mesh() is not None else self.conv(x)
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


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool padded by k // 2 with -inf (JAX max_pool_same);
    on the rank's band inside parallel/spatial.py:spatial."""
    if spatial.space_mesh() is not None:
        return spatial.max_pool_same(x, k)
    return F.max_pool2d(x, k, 1, k // 2)


class DWConv(nn.Module):
    """Depth-wise Conv, groups = gcd(c1, c2), under the JAX child name `dw`
    (JAX nn/common.py:350; reference models/common.py:67-70)."""

    def __init__(self, c1, c2, k=1, s=1, d=1, act=True):
        super().__init__()
        self.dw = Conv(c1, c2, k, s, None, math.gcd(c1, c2), d, act)

    def forward(self, x):
        return self.dw(x)


class SPP(nn.Module):
    """Spatial pyramid pooling: one 1x1 Conv, stride-1 max pools of each size
    in `k` beside it, a 1x1 Conv over the five (JAX nn/common.py:507;
    reference models/common.py:207-220)."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [max_pool_same(x, k) for k in self.k], 1))


class GhostConv(nn.Module):
    """Ghost convolution: a Conv to c2 / 2 channels and a depthwise 5x5 Conv
    of it beside it (JAX nn/common.py:571; reference models/common.py:253-263)."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck under JAX's child names (JAX nn/common.py:589;
    reference models/common.py:266-279): gc1, at s=2 a depthwise `dw`, gc2;
    the shortcut is the input, or at s=2 a depthwise `sc_dw` and a 1x1 `sc_pw`."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.gc1 = GhostConv(c1, c_, 1, 1)
        self.dw = DWConv(c_, c_, k, s, act=False) if s == 2 else None
        self.gc2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.sc_dw = DWConv(c1, c1, k, s, act=False)
            self.sc_pw = Conv(c1, c2, 1, 1, act=False)
        self.s = s

    def forward(self, x):
        y = self.gc1(x)
        if self.s == 2:
            y = self.dw(y)
        y = self.gc2(y)
        return y + (self.sc_pw(self.sc_dw(x)) if self.s == 2 else x)


class TransformerLayer(nn.Module):
    """The JAX package's transformer layer (JAX nn/common.py:865; reference
    models/common.py:79-93) under JAX's parameter names: bias-free q/k/v
    Linears, then nn.MultiheadAttention's math written out with its joint
    in-projection as three Linears `in_q`/`in_k`/`in_v` with bias, the
    attention softmax in float32 and `out_proj`, a residual, and two bias-free
    Linears `fc1`, `fc2` with a residual. x: (b, seq, c)."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v = (nn.Linear(c, c, bias=False) for _ in range(3))
        self.in_q, self.in_k, self.in_v = (nn.Linear(c, c) for _ in range(3))
        self.out_proj = nn.Linear(c, c)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        b, s, c = x.shape
        hd = c // self.num_heads
        qh, kh, vh = (proj(lin(x)).view(b, s, self.num_heads, hd).transpose(1, 2)
                      for lin, proj in ((self.q, self.in_q), (self.k, self.in_k),
                                        (self.v, self.in_v)))
        attn = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
        attn = attn.float().softmax(-1).to(qh.dtype)
        x = self.out_proj((attn @ vh).transpose(1, 2).reshape(b, s, c)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Transformer over a feature map (JAX nn/common.py:900; reference
    models/common.py:96-112): a Conv to c2 when the width changes, the map
    flattened to (b, h·w, c2) in row-major order plus a Linear of itself, then
    `num_layers` TransformerLayers (`tr.{j}`)."""

    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, _, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        p = self.tr(p + self.linear(p))
        return p.transpose(1, 2).reshape(b, self.c2, h, w)


class ZeroPad2d(nn.Module):
    """Zero padding (left, right, top, bottom), as nn.ZeroPad2d
    (JAX nn/common.py:843)."""

    def __init__(self, padding=(0, 1, 0, 1)):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x):
        return F.pad(x, self.padding)


class SPPF(nn.Module):
    """SPP-Fast: 3 chained k×k stride-1 max pools (reference models/common.py:223-238)."""

    def __init__(self, c1, c2, k=5, act=True):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, act=act)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = max_pool_same(x, self.k)
        y2 = max_pool_same(y1, self.k)
        y3 = max_pool_same(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


def _resize_matrix(n_in: int, n_out: int, align_corners: bool, antialias: bool,
                   like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) weights of F.interpolate's bilinear resize along one
    axis: the resize of an identity along its rows (its columns keep their
    size, which that resize leaves exactly as they are)."""
    eye = torch.eye(n_in, dtype=like.dtype, device=like.device)[None, None]
    return F.interpolate(eye, size=(n_out, n_in), mode="bilinear", align_corners=align_corners,
                         antialias=antialias)[0, 0]


class _DeterministicResize(torch.autograd.Function):
    """F.interpolate's bilinear resize whose backward is two matrix products,
    Ayᵀ·g·Ax, with each axis' weights from `_resize_matrix`. CUDA's own
    backward scatters with atomics, so its sums change order from run to run
    and torch.use_deterministic_algorithms(True) refuses it."""

    @staticmethod
    def forward(ctx, x, size, align_corners, antialias):
        ctx.resize = (tuple(x.shape[-2:]), tuple(size), align_corners, antialias)
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners,
                             antialias=antialias)

    @staticmethod
    def backward(ctx, g):
        (hi, wi), (ho, wo), align_corners, antialias = ctx.resize
        ay = _resize_matrix(hi, ho, align_corners, antialias, g)
        ax = _resize_matrix(wi, wo, align_corners, antialias, g)
        return ay.T @ g @ ax, None, None, None


def interpolate_bilinear(x: torch.Tensor, size, align_corners: bool,
                         antialias: bool = False) -> torch.Tensor:
    """F.interpolate(mode="bilinear"); under torch.use_deterministic_algorithms
    a CUDA tensor that needs a gradient goes through `_DeterministicResize`,
    as torch's own ops take their deterministic variants there."""
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled() \
            and torch.are_deterministic_algorithms_enabled():
        return _DeterministicResize.apply(x, tuple(size), align_corners, antialias)
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners,
                         antialias=antialias)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor with half-pixel centers, as JAX's
    `resize_bilinear` (`jax.image.resize(..., "bilinear")`, JAX
    nn/common.py:284): that resize antialiases when it shrinks, so this one
    does too (antialias=True; on an enlargement the flag changes nothing)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return interpolate_bilinear(x, size, align_corners=False, antialias=True)


class C3Ghost(C3):
    """C3 with GhostBottleneck inner blocks (JAX nn/common.py:612)."""

    def inner(self, c_, n, shortcut, g, act):
        return [GhostBottleneck(c_, c_) for _ in range(n)]


class C3TR(C3):
    """C3 whose inner block is one TransformerBlock of 4 heads and n layers
    (JAX nn/common.py:920). The block is `m`, as in the reference; the JAX
    tree calls it `m_tr` (io/weights.py maps the name)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True):
        super().__init__(c1, c2, n, shortcut, g, e, act)
        self.m = self.m[0]

    def inner(self, c_, n, shortcut, g, act):
        return [TransformerBlock(c_, c_, 4, n)]


class C3Conv(C3):
    """C3 whose inner blocks are plain 3x3 Convs, the semantic scripts' own
    "C3" (JAX nn/common.py:487). With n=0 it is the split and merge alone,
    which rows like `[-1, 3, C3, [512, False]]` build (int(False) == 0)."""

    def inner(self, c_, n, shortcut, g, act):
        return [Conv(c_, c_, 3, 1, g=g, act=act) for _ in range(n)]


class C2f(nn.Module):
    """This fork's C2f (JAX nn/common.py:619; reference
    yolov8/seg_jaccardloss_yolov8.py:401-414): split, n plain 3x3 Convs each
    on the last piece, merge, and a residual when c1 == c2. Upstream
    ultralytics' C2f uses Bottlenecks instead."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1, act=act)
        self.m = nn.ModuleList(Conv(self.c, self.c, 3, 1, g=g, act=act) for _ in range(n))
        self.cv2 = Conv((2 + n) * self.c, c2, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            ys.append(m(ys[-1]))
        out = self.cv2(torch.cat(ys, 1))
        return out + x if self.add else out


class C3k2(nn.Module):
    """This fork's C3k2 (JAX nn/common.py:645; reference
    yolo9-seg/seg_diceloss_yolov9.py:451-472): the C3 skeleton with a stack of
    n plain 3x3 Convs and a residual when c1 == c2."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.m = nn.ModuleList(Conv(c_, c_, 3, 1, g=g, act=act) for _ in range(n))
        self.cv2 = Conv(c1, c_, 1, 1, act=act)
        self.cv3 = Conv(2 * c_, c2, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y1 = self.cv1(x)
        for m in self.m:
            y1 = m(y1)
        out = self.cv3(torch.cat([y1, self.cv2(x)], 1))
        return out + x if self.add else out


class GAM(nn.Module):
    """Global aggregation channel attention (JAX nn/common.py:670; reference
    yolo9-seg/seg_diceloss_yolov9.py:475-510): x gated by the sigmoid of
    conv2(mean pool of conv1(x)) + conv3(max pool of conv1(x)). `conv1` is
    one module called twice, as in JAX: in training its BatchNorm's running
    statistics move twice a forward."""

    def __init__(self, c1, c, k=1, s=1, e=0.25):
        super().__init__()
        c_ = int(c * e)
        self.conv1 = Conv(c1, c_, k, s)
        self.conv2 = Conv(c_, c, k, s, act=False)
        self.conv3 = Conv(c_, c, k, s, act=False)

    def forward(self, x):
        y1 = self.conv2(self.conv1(x).mean((2, 3), keepdim=True))
        y2 = self.conv3(self.conv1(x).amax((2, 3), keepdim=True))
        return x * torch.sigmoid(y1 + y2)


class Concat(nn.Module):
    """Concatenate a list of tensors along dimension `d` (1 = channels). With
    `align` every input is first resized bilinearly to the first one's size,
    as the semantic graphs' Concat does (JAX nn/common.py:720-734)."""

    def __init__(self, d=1, align=False):
        super().__init__()
        self.d = d
        self.align = align

    def forward(self, xs):
        if self.align:
            size = xs[0].shape[-2:]
            xs = [resize_bilinear(t, size) for t in xs]
        return torch.cat(xs, self.d)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of an NCHW tensor as JAX's `resize_nearest`
    (`jax.image.resize(..., "nearest")`, JAX nn/common.py:292): output index i
    reads input floor((i + 0.5) · n_in / n_out), computed in float32 as
    jax.image does. torch's "nearest" reads floor(i · n_in / n_out)."""
    for dim, n_out in zip((2, 3), size):
        n_in = x.shape[dim]
        if n_in != n_out:
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
                              * n_in / n_out).long()
            x = x.index_select(dim, idx)
    return x


class Upsample(nn.Module):
    """nn.Upsample as JAX's (JAX nn/common.py:813): to `size`, or to
    int(side · scale_factor); mode "nearest" repeats at an integer factor and
    otherwise takes JAX's half-pixel nearest (`resize_nearest`); every other
    mode is JAX's bilinear resize (`resize_bilinear`, antialiased when it
    shrinks), "bicubic" included, as JAX treats it."""

    def __init__(self, size=None, scale_factor=2.0, mode="nearest"):
        super().__init__()
        self.size = tuple(size) if size is not None else None
        self.scale_factor = scale_factor
        self.mode = mode

    def forward(self, x):
        sf = self.scale_factor
        if self.mode == "nearest" and self.size is None and sf is not None \
                and float(sf).is_integer():
            return F.interpolate(x, scale_factor=int(sf), mode="nearest")
        size = self.size or (int(x.shape[2] * sf), int(x.shape[3] * sf))
        if self.mode == "nearest":
            return resize_nearest(x, size)
        return resize_bilinear(x, size)


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


class Classify(nn.Module):
    """Classification head (reference models/common.py:851-864; JAX
    nn/common.py:943): a list input concatenated on channels, `conv` to 1280
    channels, the global mean, `nn.Dropout(dropout)` when dropout > 0, and
    `linear` to c2. The names are the reference's, so a YOLOv5-cls
    state_dict (`model.9.conv.conv.weight`, `model.9.linear.weight`) loads."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, dropout=0.0):
        super().__init__()
        c_ = 1280  # efficientnet_b0 size
        self.conv = Conv(sum(c1) if isinstance(c1, (list, tuple)) else c1, c_, k, s, p, g)
        self.drop = nn.Dropout(dropout) if dropout else None
        self.linear = nn.Linear(c_, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        x = self.conv(x).mean((2, 3))
        if self.drop is not None:
            x = self.drop(x)
        return self.linear(x)


class ConvTranspose(nn.Module):
    """nn.ConvTranspose2d rows (JAX nn/common.py:366): one transposed conv
    `conv` with a bias, torch's padding `p`. Its weight is torch's (c1, c2 / g,
    k, k): JAX's ConvTranspose kernel (k, k, c2, c1) under
    transpose_kernel=True maps to it by io/weights.py's HWIO -> OIHW
    transpose, the spatial flip being lax's own."""

    def __init__(self, c1, c2, k=2, s=2, p=0, g=1, bias=True):
        super().__init__()
        self.conv = nn.ConvTranspose2d(c1, c2, k, s, p, groups=g, bias=bias)

    def forward(self, x):
        return self.conv(x)


class DWConvTranspose2d(ConvTranspose):
    """JAX's DWConvTranspose2d (JAX nn/common.py:395): its compiler passes
    c2, k, s, p and keeps g = 1, so unlike the reference's it is not
    depthwise (ROADMAP §C)."""


class BottleneckCSP(nn.Module):
    """CSP bottleneck, v4 style (JAX nn/common.py:417; reference
    models/common.py:128-144): Conv `cv1`, n Bottlenecks `m`, raw 1x1 convs
    `cv3` (after m) and `cv2` (beside it), one BatchNorm `bn` and SiLU over
    their concatenation, Conv `cv4`. fuse() leaves `bn` as it is, as JAX's."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.cv4 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x):
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(F.silu(self.bn(y)))


class CrossConv(nn.Module):
    """Cross convolution: a 1 x k Conv then a k x 1 Conv, a residual when
    shortcut and c1 == c2 (JAX nn/common.py:441; reference models/common.py:147-158)."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s))
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3x(C3):
    """C3 with CrossConv inner blocks (JAX nn/common.py:499)."""

    def inner(self, c_, n, shortcut, g, act):
        return [CrossConv(c_, c_, 3, 1, g, 1.0, shortcut) for _ in range(n)]


class C3SPP(C3):
    """C3 whose inner block is one SPP of kernels `k` (JAX nn/common.py:540;
    reference models/common.py:191-196), whatever n. The block is `m`, as in
    the reference; the JAX tree calls it `m_spp` (io/weights.py maps the name)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True, k=(5, 9, 13)):
        self.k = tuple(k)
        super().__init__(c1, c2, n, shortcut, g, e, act)
        self.m = self.m[0]

    def inner(self, c_, n, shortcut, g, act):
        return [SPP(c_, c_, self.k)]


class Focus(nn.Module):
    """Space to depth, then a Conv (JAX nn/common.py:549; reference
    models/common.py:241-250): the channels of the (even, even), (odd, even),
    (even, odd), (odd, odd) (row, column) pixels, in that order."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], 1))


class Contract(nn.Module):
    """(b, c, h, w) -> (b, c·s², h/s, w/s), channel (sy, sx, c) order (JAX
    nn/common.py:692; reference models/common.py:282-293)."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class Expand(nn.Module):
    """(b, c, h, w) -> (b, c/s², h·s, w·s), the inverse of Contract (JAX
    nn/common.py:706; reference models/common.py:296-307)."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // s ** 2, h * s, w * s)


class Sum(nn.Module):
    """Sum of n inputs; with `weight`, the inputs past the first are scaled by
    the gates 2·sigmoid(w), w starting at -arange(1, n) / 2 (JAX
    nn/common.py:737; reference models/experimental.py:14-32)."""

    def __init__(self, n, weight=False):
        super().__init__()
        self.w = nn.Parameter(-torch.arange(1.0, n) / 2) if weight else None

    def forward(self, xs):
        y = xs[0]
        w = 2.0 * torch.sigmoid(self.w) if self.w is not None else None
        for i, x in enumerate(xs[1:]):
            y = y + (x * w[i] if w is not None else x)
        return y


def mixconv_splits(c2: int, k, equal_ch: bool) -> list:
    """Output channels of each MixConv2d branch (JAX nn/common.py:781-796):
    equal shares with the remainder on the last branches (output channel j
    to branch floor(j·n/c2)), or shares proportional to 1/k², the rounding
    residual on the largest."""
    n = len(k)
    if equal_ch:
        return np.bincount(np.floor(np.linspace(0, n - 1e-6, c2)).astype(int),
                           minlength=n).tolist()
    inv = 1.0 / np.asarray(k, np.float64) ** 2
    splits = np.round(c2 * inv / inv.sum()).astype(int)
    splits[int(np.argmax(splits))] += c2 - int(splits.sum())
    return splits.tolist()


class MixConv2d(nn.Module):
    """Mixed kernel sizes (JAX nn/common.py:760; reference
    models/experimental.py:35-57): one bias-free conv a kernel size over the
    input, groups gcd(c1, its channels), concatenated, BatchNorm `bn`, SiLU.
    A branch of 0 channels is left out and its index skipped, as JAX's
    `m_{i}` names skip it, so the branches are a ModuleDict `m`."""

    def __init__(self, c1, c2, k=(1, 3), s=1, equal_ch=True):
        super().__init__()
        self.m = nn.ModuleDict({
            str(i): nn.Conv2d(c1, cc, kk, s, kk // 2, groups=math.gcd(c1, cc), bias=False)
            for i, (kk, cc) in enumerate(zip(k, mixconv_splits(c2, k, equal_ch))) if cc})
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.silu(self.bn(torch.cat([m(x) for m in self.m.values()], 1)))


class BatchNormLayer(nn.Module):
    """A config's `nn.BatchNorm2d` row (JAX nn/common.py:835): one BatchNorm
    under JAX's child name `bn`; fuse() leaves it, as JAX's."""

    def __init__(self, c1):
        super().__init__()
        self.bn = BatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return self.bn(x)
