"""Torchvision-architecture backbone stages, NCHW (port of
yolo_dual_tpu/nn/torchvision_backbones.py; reference models/common.py:866-1273).

Twelve torchvision models, each cut into the three sequential stages
`<family>1/2/3` that the model configs tap:

  resnet18/34/50, wide_resnet50_2 : children[:6] / [6] / [7]
  mobilenet_v3_small              : features[:4] / [4:9] / [9:]
  efficientnet_b0 / b1            : features[:4] / [4:6] / [6:]
  efficientnet_v2_s               : features[:4] / [4:6] / [6:]
  mobilenet_v2                    : features[:7] / [7:14] / [14:19]
  vgg11_bn                        : features[:14] / [14:21] / [21:28]
  convnext_tiny                   : features[:4] / [4:6] / [6:]
  regnet_y_400mf                  : stem+trunk[:2] / trunk[2] / trunk[3]

The structure is the JAX package's, which departs from torchvision in two
places the port copies: no stochastic depth and no dropout inside the stages,
and JAX's SqueezeExcite widths (MBConv and RegNetY squeeze to a quarter of
the block's input width). Child names are JAX's tree names (`layer1_0.conv1`,
`s2_b4.ln`, `ds2_conv`, ...), so a JAX tree maps onto a stage by a change of
layout (io/weights.py:state_dict_from_flax), except the MobileNet blocks,
JAX's `block{n}`, which are `layer.{n}` here as that mapping names them.

Every BatchNorm is a `FixedProfileBatchNorm2d` with its family's profile:
MobileNetV3 and the EfficientNets eps 1e-3 and torch momentum 0.01 (flax
0.99), the others eps 1e-5 and 0.1 (flax 0.9); a graph's own profile
(models/model.py:GraphModel) passes them by. ConvNeXt's LayerNorms (eps 1e-6)
and Linear layers act on the channels-last view, as JAX applies them on NHWC,
and its GELU is the tanh approximation, `jax.nn.gelu`'s default.

A stage takes its input width `c1` from the graph and computes every other
width from its family; `STAGE_OUT[name]` is its output width, which a config
row declares as `c2` (0 where the caller leaves it to the stage, as
classify.train's `build_classifier` does).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.nn.spp import FixedProfileBatchNorm2d


def _bn(c, eps=1e-5, momentum=0.1):
    return FixedProfileBatchNorm2d(c, eps=eps, momentum=momentum)


def _bn3(c):  # MobileNetV3 and EfficientNet profile (flax momentum 0.99)
    return _bn(c, 1e-3, 0.01)


def _conv(c1, c2, k, s=1, p=None, g=1, bias=False):
    return nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, groups=g, bias=bias)


class SqueezeExcite(nn.Module):
    """SE block: global mean, 1x1 `fc1` to `squeeze_ch`, ReLU, 1x1 `fc2` back,
    then a sigmoid gate, or a hard sigmoid with gate="hard" (MobileNetV3)."""

    def __init__(self, c1, squeeze_ch, gate="sigmoid"):
        super().__init__()
        self.fc1 = nn.Conv2d(c1, squeeze_ch, 1)
        self.fc2 = nn.Conv2d(squeeze_ch, c1, 1)
        self.gate = F.hardsigmoid if gate == "hard" else torch.sigmoid

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * self.gate(s)


# ---------------------------------------------------------------------------
# ResNet family
# ---------------------------------------------------------------------------


class TVBasicBlock(nn.Module):
    def __init__(self, c1, planes, stride=1):
        super().__init__()
        self.conv1, self.bn1 = _conv(c1, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        self.down = stride != 1 or c1 != planes
        if self.down:
            self.down_conv, self.down_bn = _conv(c1, planes, 1, stride, 0), _bn(planes)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


class TVBottleneck(nn.Module):
    def __init__(self, c1, planes, out, stride=1):
        super().__init__()
        self.conv1, self.bn1 = _conv(c1, planes, 1, 1, 0), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1, 1, 0), _bn(out)
        self.down = stride != 1 or c1 != out
        if self.down:
            self.down_conv, self.down_bn = _conv(c1, out, 1, stride, 0), _bn(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


RESNETS = {  # arch: (block, depths, base width)
    "resnet18": ("basic", [2, 2, 2, 2], 64),
    "resnet34": ("basic", [3, 4, 6, 3], 64),
    "resnet50": ("bottleneck", [3, 4, 6, 3], 64),
    "wide_resnet50_2": ("bottleneck", [3, 4, 6, 3], 128),
}


class _Sequence(nn.Module):
    """A stage whose children run in the order they were added."""

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x


class _ResNetStage(_Sequence):
    def __init__(self, arch, stage, c1=3, c2=0):
        super().__init__()
        kind, depths, width = RESNETS[arch]
        if stage == 1:
            self.conv1, self.bn1 = _conv(c1, 64, 7, 2, 3), _bn(64)
            self.relu, self.pool = nn.ReLU(), nn.MaxPool2d(3, 2, 1)
            c1 = 64
        for idx, stride in {1: ((0, 1), (1, 2)), 2: ((2, 2),), 3: ((3, 2),)}[stage]:
            mid = width * 2 ** idx                               # bottleneck mid width
            out = mid if kind == "basic" else 256 * 2 ** idx     # x4 expansion on the 64 base
            for bi in range(depths[idx]):
                s = stride if bi == 0 else 1
                blk = TVBasicBlock(c1, out, s) if kind == "basic" else TVBottleneck(c1, mid, out, s)
                self.add_module(f"layer{idx + 1}_{bi}", blk)
                c1 = out


# ---------------------------------------------------------------------------
# MobileNetV2 / V3
# ---------------------------------------------------------------------------


class InvertedResidualV2(nn.Module):
    def __init__(self, c1, c2, stride, expand):
        super().__init__()
        hid = c1 * expand
        self.expand = expand != 1
        if self.expand:
            self.pw, self.pw_bn = _conv(c1, hid, 1, 1, 0), _bn(hid)
        self.dw, self.dw_bn = _conv(hid, hid, 3, stride, g=hid), _bn(hid)
        self.proj, self.proj_bn = _conv(hid, c2, 1, 1, 0), _bn(c2)
        self.residual = stride == 1 and c1 == c2

    def forward(self, x):
        y = F.relu6(self.pw_bn(self.pw(x))) if self.expand else x
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.proj_bn(self.proj(y))
        return x + y if self.residual else y


class InvertedResidualV3(nn.Module):
    def __init__(self, c1, c2, k, stride, exp_ch, use_se, act):
        super().__init__()
        self.act = F.relu if act == "relu" else F.hardswish
        self.expand = exp_ch != c1
        if self.expand:
            self.pw, self.pw_bn = _conv(c1, exp_ch, 1, 1, 0), _bn3(exp_ch)
        self.dw, self.dw_bn = _conv(exp_ch, exp_ch, k, stride, g=exp_ch), _bn3(exp_ch)
        self.se = SqueezeExcite(exp_ch, max(8, (exp_ch // 4 + 4) // 8 * 8), "hard") \
            if use_se else None
        self.proj, self.proj_bn = _conv(exp_ch, c2, 1, 1, 0), _bn3(c2)
        self.residual = stride == 1 and c1 == c2

    def forward(self, x):
        y = self.act(self.pw_bn(self.pw(x))) if self.expand else x
        y = self.act(self.dw_bn(self.dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.proj_bn(self.proj(y))
        return x + y if self.residual else y


# mobilenet_v3_small feature config: (k, exp, out, se, act, stride)
MNV3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hard", 2),
    (5, 240, 40, True, "hard", 1),
    (5, 240, 40, True, "hard", 1),
    (5, 120, 48, True, "hard", 1),
    (5, 144, 48, True, "hard", 1),
    (5, 288, 96, True, "hard", 2),
    (5, 576, 96, True, "hard", 1),
    (5, 576, 96, True, "hard", 1),
]

# mobilenet_v2 features 1..17: (expand, out, stride)
MNV2 = [
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),
    (6, 160, 2), (6, 160, 1), (6, 160, 1),
    (6, 320, 1),
]


class _MNV3Stage(nn.Module):
    def __init__(self, stage, c1=3, c2=0):
        super().__init__()
        self.stage = stage
        if stage == 1:  # features[:4] = stem + blocks 0..2
            self.stem, self.stem_bn = _conv(c1, 16, 3, 2), _bn3(16)
            c1, start, stop = 16, 0, 3
        else:           # features[4:9] = blocks 3..7; features[9:] = blocks 8..10 + 1x1 conv 576
            start, stop = (3, 8) if stage == 2 else (8, len(MNV3_SMALL))
        self.layer = nn.ModuleDict()
        for i in range(start, stop):
            k, e, c, se, act, s = MNV3_SMALL[i]
            self.layer[str(i)] = InvertedResidualV3(c1, c, k, s, e, se, act)
            c1 = c
        if stage == 3:
            self.head, self.head_bn = _conv(c1, 576, 1, 1, 0), _bn3(576)

    def forward(self, x):
        if self.stage == 1:
            x = F.hardswish(self.stem_bn(self.stem(x)))
        for blk in self.layer.values():
            x = blk(x)
        if self.stage == 3:
            x = F.hardswish(self.head_bn(self.head(x)))
        return x


class _MNV2Stage(nn.Module):
    def __init__(self, stage, c1=3, c2=0):
        super().__init__()
        self.stage = stage
        if stage == 1:  # features[:7] = stem + IR 1..6
            self.stem, self.stem_bn = _conv(c1, 32, 3, 2), _bn(32)
            c1, start, stop = 32, 0, 6
        else:           # features[7:14] = IR 7..13; features[14:19] = IR 14..17 + conv 1280
            start, stop = (6, 13) if stage == 2 else (13, len(MNV2))
        self.layer = nn.ModuleDict()
        for i in range(start, stop):
            e, c, s = MNV2[i]
            self.layer[str(i)] = InvertedResidualV2(c1, c, s, e)
            c1 = c
        if stage == 3:
            self.head, self.head_bn = _conv(c1, 1280, 1, 1, 0), _bn(1280)

    def forward(self, x):
        if self.stage == 1:
            x = F.relu6(self.stem_bn(self.stem(x)))
        for blk in self.layer.values():
            x = blk(x)
        if self.stage == 3:
            x = F.relu6(self.head_bn(self.head(x)))
        return x


# ---------------------------------------------------------------------------
# EfficientNet B0/B1 and V2-S
# ---------------------------------------------------------------------------


class MBConv(nn.Module):
    def __init__(self, c1, c2, k, stride, expand):
        super().__init__()
        hid = c1 * expand
        self.expand = expand != 1
        if self.expand:
            self.pw, self.pw_bn = _conv(c1, hid, 1, 1, 0), _bn3(hid)
        self.dw, self.dw_bn = _conv(hid, hid, k, stride, g=hid), _bn3(hid)
        self.se = SqueezeExcite(hid, max(1, c1 // 4), "sigmoid")
        self.proj, self.proj_bn = _conv(hid, c2, 1, 1, 0), _bn3(c2)
        self.residual = stride == 1 and c1 == c2

    def forward(self, x):
        y = F.silu(self.pw_bn(self.pw(x))) if self.expand else x
        y = self.se(F.silu(self.dw_bn(self.dw(y))))
        y = self.proj_bn(self.proj(y))
        return x + y if self.residual else y


class FusedMBConv(nn.Module):
    """Fused MBConv: a k x k conv to the expanded width and a 1x1 projection;
    at expansion 1 the k x k conv goes straight to c2 and there is no
    projection."""

    def __init__(self, c1, c2, k, stride, expand):
        super().__init__()
        self.expand = expand != 1
        hid = c1 * expand if self.expand else c2
        self.fused, self.fused_bn = _conv(c1, hid, k, stride), _bn3(hid)
        if self.expand:
            self.proj, self.proj_bn = _conv(hid, c2, 1, 1, 0), _bn3(c2)
        self.residual = stride == 1 and c1 == c2

    def forward(self, x):
        y = F.silu(self.fused_bn(self.fused(x)))
        if self.expand:
            y = self.proj_bn(self.proj(y))
        return x + y if self.residual else y


# efficientnet-b0 stages: (expand, c, repeats, stride, k); b1 repeats differ
EFF_B0 = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
          (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
EFF_B1 = [(1, 16, 2, 1, 3), (6, 24, 3, 2, 3), (6, 40, 3, 2, 5), (6, 80, 4, 2, 3),
          (6, 112, 4, 1, 5), (6, 192, 5, 2, 5), (6, 320, 2, 1, 3)]
# efficientnet_v2_s: (block, expand, c, repeats, stride, k)
EFF_V2S = [("fused", 1, 24, 2, 1, 3), ("fused", 4, 48, 4, 2, 3),
           ("fused", 4, 64, 4, 2, 3), ("mb", 4, 128, 6, 2, 3),
           ("mb", 6, 160, 9, 1, 3), ("mb", 6, 256, 15, 2, 3)]
EFFS = {"b0": (EFF_B0, 32), "b1": (EFF_B1, 32), "v2s": (EFF_V2S, 24)}  # (stages, stem width)


class _EffStage(_Sequence):
    def __init__(self, arch, stage, c1=3, c2=0):
        super().__init__()
        cfg, stem_ch = EFFS[arch]
        if stage == 1:
            self.stem, self.stem_bn, self.stem_act = _conv(c1, stem_ch, 3, 2), _bn3(stem_ch), \
                nn.SiLU()
            c1 = stem_ch
        # features[0] = stem, features[1..n] = stages, features[-1] = head conv:
        # [:4] -> stem + stages 0..2; [4:6] -> stages 3..4; [6:] -> stages 5.. + head
        for si in range(*{1: (0, 3), 2: (3, 5), 3: (5, len(cfg))}[stage]):
            kind, e, c, r, s, k = cfg[si] if arch == "v2s" else ("mb", *cfg[si])
            for bi in range(r):
                cls = FusedMBConv if kind == "fused" else MBConv
                self.add_module(f"s{si}_b{bi}", cls(c1, c, k, s if bi == 0 else 1, e))
                c1 = c
        if stage == 3:
            self.head, self.head_bn, self.head_act = _conv(c1, 1280, 1, 1, 0), _bn3(1280), \
                nn.SiLU()


# ---------------------------------------------------------------------------
# RegNet-Y 400MF
# ---------------------------------------------------------------------------


class RegNetYBlock(nn.Module):
    """RegNetY block: 1x1, grouped 3x3 (c2 // group_width groups), SE
    squeezing to a quarter of the block's input width, 1x1, residual."""

    def __init__(self, c1, c2, stride, group_width=8):
        super().__init__()
        self.a, self.a_bn = _conv(c1, c2, 1, 1, 0), _bn(c2)
        self.b, self.b_bn = _conv(c2, c2, 3, stride, g=max(1, c2 // group_width)), _bn(c2)
        self.se = SqueezeExcite(c2, max(1, c1 // 4), "sigmoid")
        self.c, self.c_bn = _conv(c2, c2, 1, 1, 0), _bn(c2)
        self.down = None  # JAX's `down` projection, where the stride or the width changes
        if stride != 1 or c1 != c2:
            self.down, self.down_bn = _conv(c1, c2, 1, stride, 0), _bn(c2)

    def forward(self, x):
        y = F.relu(self.a_bn(self.a(x)))
        y = self.se(F.relu(self.b_bn(self.b(y))))
        y = self.c_bn(self.c(y))
        if self.down is not None:
            x = self.down_bn(self.down(x))
        return F.relu(x + y)


REGNET_Y400 = [(48, 1), (104, 3), (208, 6), (440, 6)]  # (width, depth), group width 8


class _RegNetStage(_Sequence):
    def __init__(self, stage, c1=3, c2=0):
        super().__init__()
        if stage == 1:  # stem + trunk stages 0, 1
            self.stem, self.stem_bn, self.stem_act = _conv(c1, 32, 3, 2), _bn(32), nn.ReLU()
            c1 = 32
        for si in {1: (0, 1), 2: (2,), 3: (3,)}[stage]:
            w, d = REGNET_Y400[si]
            for bi in range(d):
                self.add_module(f"t{si}_b{bi}", RegNetYBlock(c1, w, 2 if bi == 0 else 1))
                c1 = w


# ---------------------------------------------------------------------------
# VGG11-BN and ConvNeXt-tiny
# ---------------------------------------------------------------------------


class _VGG11Stage(nn.Module):
    # features[:14]: 64 P 128 P 256 256; [14:21]: P 512 512; [21:28]: P 512 512
    PLAN = {1: (("c0", 64), "P", ("c1", 128), "P", ("c2", 256), ("c3", 256)),
            2: ("P", ("c4", 512), ("c5", 512)), 3: ("P", ("c6", 512), ("c7", 512))}

    def __init__(self, stage, c1=3, c2=0):
        super().__init__()
        self.plan = self.PLAN[stage]
        for step in self.plan:
            if step != "P":
                name, c = step
                self.add_module(f"{name}_conv", _conv(c1, c, 3))
                self.add_module(f"{name}_bn", _bn(c))
                c1 = c

    def forward(self, x):
        for step in self.plan:
            if step == "P":
                x = F.max_pool2d(x, 2, 2)
            else:
                name = step[0]
                x = F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))
        return x


class ChannelsLastLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's LayerNorm on NHWC)."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv, LayerNorm, Linear 4x, GELU (tanh), Linear, layer
    scale `gamma`, residual; the norm and the MLP on the channels-last view."""

    def __init__(self, dim):
        super().__init__()
        self.dw = _conv(dim, dim, 7, 1, 3, g=dim, bias=True)
        self.ln = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.ln(self.dw(x).permute(0, 2, 3, 1))
        y = self.mlp2(F.gelu(self.mlp1(y), approximate="tanh")) * self.gamma
        return x + y.permute(0, 3, 1, 2)


CONVNEXT_T = [(96, 3), (192, 3), (384, 9), (768, 3)]  # (width, depth)


class _ConvNeXtStage(_Sequence):
    def __init__(self, stage, c1=3, c2=0):
        super().__init__()
        if stage == 1:  # features[:4]: stem + stage 0 + downsample + stage 1
            self.stem_conv = nn.Conv2d(c1, 96, 4, 4)
            self.stem_ln = ChannelsLastLayerNorm(96, eps=1e-6)
            c1, groups = 96, (0, 1)
        else:           # features[4:6], [6:]: downsample + stage 2, downsample + stage 3
            groups = (stage,)
        for si in groups:
            w, d = CONVNEXT_T[si]
            if si > 0:
                self.add_module(f"ds{si}_ln", ChannelsLastLayerNorm(c1, eps=1e-6))
                self.add_module(f"ds{si}_conv", nn.Conv2d(c1, w, 2, 2))
            for i in range(d):
                self.add_module(f"s{si}_b{i}", ConvNeXtBlock(w))
            c1 = w


# ---------------------------------------------------------------------------
# Registry of <family><1|2|3> stage modules
# ---------------------------------------------------------------------------

FAMILIES = {  # config name -> stage class maker (stage, c1) -> module
    **{arch: (lambda arch: lambda s, c1: _ResNetStage(arch, s, c1))(arch) for arch in RESNETS},
    "MobileNetV3s": _MNV3Stage,
    "mobilenet_v2": _MNV2Stage,
    **{f"efficientnet_{n}": (lambda a: lambda s, c1: _EffStage(a, s, c1))(a)
       for a, n in (("b0", "b0"), ("b1", "b1"), ("v2s", "v2_s"))},
    "RegNety400": _RegNetStage,
    "vgg11_bn": _VGG11Stage,
    "convnext_tiny": _ConvNeXtStage,
}
STAGE_OUT = {
    **{f"{a}{i}": w for a, ws in (("resnet18", (128, 256, 512)), ("resnet34", (128, 256, 512)),
                                  ("resnet50", (512, 1024, 2048)),
                                  ("wide_resnet50_2", (512, 1024, 2048)),
                                  ("MobileNetV3s", (24, 48, 576)),
                                  ("mobilenet_v2", (32, 96, 1280)),
                                  ("efficientnet_b0", (40, 112, 1280)),
                                  ("efficientnet_b1", (40, 112, 1280)),
                                  ("efficientnet_v2_s", (64, 160, 1280)),
                                  ("RegNety400", (104, 208, 440)),
                                  ("vgg11_bn", (256, 512, 512)),
                                  ("convnext_tiny", (192, 384, 768)))
       for i, w in zip((1, 2, 3), ws)},
}


def build_stage(name: str, c1: int, c2: int = 0) -> nn.Module:
    """The stage `name` (`<family><1|2|3>`) on a `c1`-channel input. `c2` is
    the config row's declared width: 0, or STAGE_OUT[name]."""
    if c2 and c2 != STAGE_OUT[name]:
        raise ValueError(f"{name} outputs {STAGE_OUT[name]} channels; the config row says {c2}")
    return FAMILIES[name[:-1]](int(name[-1]), c1)
