"""Graph walker, DetectionModel, SegmentationModel, SemanticSegModel and
build_model (port of yolo_dual_tpu/models/model.py; reference
models/yolo.py:109-296).

The space-to-depth blocked stem that the JAX `fuse()` applies on its own
(nn/blocked.py) is a TPU layout rewrite of the same math and is not ported:
`fuse()` here only folds each Conv's BatchNorm.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.models.compiler import ModelSpec, build_module, parse_config, with_strides
from yolo_dual_tpu_torch.models.heads import Detect
from yolo_dual_tpu_torch.nn.common import Conv, resize_bilinear
from yolo_dual_tpu_torch.nn.attention import AttentionConv, AttentionStem
from yolo_dual_tpu_torch.nn.dcn import C2f_DCN, DCNv2, DCNv3
from yolo_dual_tpu_torch.nn.spp import FixedProfileBatchNorm2d
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config, select_device

_HEADS = ("Detect", "Segment")


class GraphModel(nn.Module):
    """Walks a compiled ModelSpec (reference BaseModel._forward_once,
    models/yolo.py:114-125). Layer i is `self.model[i]`, so parameter names are
    the reference's `model.{i}.…`. Every BatchNorm takes the spec's profile
    (`spec.bn_profile`) but RFB's, which keep their own (nn/spp.py:BasicConv)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.save = frozenset(spec.save)
        self.model = nn.ModuleList(build_module(layer) for layer in spec.layers)
        eps, momentum = spec.bn_profile
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d) and not isinstance(m, FixedProfileBatchNorm2d):
                m.eps, m.momentum = eps, momentum

    def forward(self, x, decode: Optional[bool] = None):
        """decode=None decodes in eval mode. Segment head output: decoded
        (pred, protos, raw) or raw ([levels], protos)."""
        if decode is None:
            decode = not self.training
        return self._walk(x, decode)

    def _walk(self, x, decode: bool):
        y = []
        out = x
        for layer, mod in zip(self.spec.layers, self.model):
            f = layer.f
            if isinstance(f, tuple):
                inp = [out if j == -1 else y[j] for j in f]
            elif f == -1:
                inp = out
            else:
                inp = y[f]
            out = mod(inp, decode=decode) if layer.name in _HEADS else mod(inp)
            y.append(out if layer.i in self.save else None)
        return out

    def fuse(self):
        """Fold every Conv's BatchNorm into its conv, in place (reference
        models/yolo.py fuse), with the BatchNorm's own eps. Inference only."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.fuse()
        return self


def _probe_strides(spec: ModelSpec) -> ModelSpec:
    """Run the graph at 256 px on the meta device (shapes only, no memory or
    FLOPs) to derive the head strides (reference models/yolo.py:190-197)."""
    head = spec.layers[-1]
    if head.name not in _HEADS:
        return spec
    s = 256
    with torch.device("meta"):
        model = GraphModel(spec).eval()
        x = torch.empty(1, spec.ch_in, s, s)
    with torch.no_grad():
        out = model(x, decode=False)
    levels = out[0] if head.name == "Segment" else out
    return with_strides(spec, [s // lvl.shape[2] for lvl in levels])  # lvl: (bs, na, ny, nx, no)


def init_weights(model: nn.Module, generator: torch.Generator):
    """Random weights from `generator` (a CPU generator): conv and linear
    weights N(0, 1/fan_in), as flax's lecun_normal init, and so C2f_DCN's
    deformable weights; DCNv2's weight U(±1/sqrt(cin·k²)) (JAX
    nn/dcn.py:289-295); the attention blocks' `rel_*` and `emb_*` N(0, 1), as
    flax's normal(1.0); zero biases; identity BatchNorms with fresh running
    stats; zero DCNv3 offset and mask heads and zero DCNv2 `conv_offset_mask`,
    as JAX initializes them (every sample on its grid point, uniform mask)."""
    def lecun(w):
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w[0].numel()))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, DCNv2):  # JAX: std over the input's channels, not a group's
                std = 1 / math.sqrt(m.weight[0].numel() * m.g)
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * std)
                m.bias.zero_()
            elif isinstance(m, C2f_DCN):
                for i in range(m.n):
                    lecun(getattr(m, f"m_{i}_dcn_weight"))
            elif isinstance(m, (AttentionConv, AttentionStem)):
                for name, w in m.named_parameters(recurse=False):
                    w.copy_(torch.randn(w.shape, generator=generator))
        for m in model.modules():
            if isinstance(m, DCNv3):
                for head in (m.offset, m.mask):
                    head.weight.zero_()
                    head.bias.zero_()
            elif isinstance(m, DCNv2):
                m.conv_offset_mask.weight.zero_()
                m.conv_offset_mask.bias.zero_()


def initialize_detect_biases(model: GraphModel):
    """Prior init of the Detect conv biases (reference models/yolo.py:253-261)."""
    head = model.model[-1]
    if not isinstance(head, Detect):
        return
    with torch.no_grad():
        for conv, s in zip(head.m, head.strides):
            b = conv.bias.view(head.na, -1)
            b[:, 4] += math.log(8 / (640 / s) ** 2)
            b[:, 5:5 + head.nc] += math.log(0.6 / (head.nc - 0.99999))


def _config(cfg) -> dict:
    return dict(cfg) if isinstance(cfg, dict) else load_config(find_cfg(cfg))


class DetectionModel(GraphModel):
    """Detection model compiled from a config with a Detect or Segment head
    (JAX models/model.py:318): a dict, a path, or the name of one of the
    package's JSON copies, e.g. "yolov5s.json" or "yolov3-tiny.yaml".

    The modules are built on the meta device and materialized on `device`;
    weights are drawn from `generator` (default: a CPU generator seeded 0), then
    the Detect bias prior is applied. Load trained weights afterwards with
    `load_state_dict(strict=True)`. `names` maps class ids to names ("0", "1",
    ...), as JAX's.
    """

    def __init__(self, cfg="yolov5s.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        dev = select_device(device)
        spec = _probe_strides(parse_config(_config(cfg), ch=ch, nc=nc))
        with torch.device("meta"):
            super().__init__(spec)
        self.to_empty(device=dev)
        self.nc = spec.nc
        self.names = {i: str(i) for i in range(spec.nc)}
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        initialize_detect_biases(self)


class SegmentationModel(DetectionModel):
    """Instance-segmentation model: a DetectionModel whose config ends in a
    Segment head (default "yolov5s-seg.json")."""

    def __init__(self, cfg="yolov5s-seg.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__(cfg, ch=ch, nc=nc, device=device, generator=generator)


class SemanticSegModel(GraphModel):
    """Dense semantic segmentation (JAX models/model.py:326-345), compiled
    from a semantic config (a dict, a path, or the name of one of the
    package's JSON copies, e.g. "resnet50.json").

    forward(x) takes (b, 3, H, W) float images in [0, 1] and returns the
    (b, nc, H, W) class scores: where the graph's output has another size
    (resnet50.json: half the input), it is resized bilinearly to the input's.
    Built on the meta device and materialized on `device`, weights drawn
    from `generator` (default: a CPU generator seeded 0); BatchNorms carry
    torch's defaults (eps 1e-5, momentum 0.1).
    """

    def __init__(self, cfg="resnet50.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        dev = select_device(device)
        spec = parse_config(_config(cfg), ch=ch, nc=nc)
        if spec.style != "semantic":
            raise ValueError("SemanticSegModel needs a semantic config (no anchors); "
                             "use SegmentationModel for detect-style configs")
        with torch.device("meta"):
            super().__init__(spec)
        self.to_empty(device=dev)
        self.nc = spec.nc
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x):
        out = self._walk(x, decode=False)
        return resize_bilinear(out, x.shape[-2:])


def build_model(cfg, task: Optional[str] = None, **kw) -> GraphModel:
    """The model of a config, its wrapper chosen from the config as JAX's
    build_model chooses it (JAX models/model.py:463): no anchors -> semantic,
    a last head row `Segment` -> segment, else detect. `task` overrides;
    `kw` goes to the wrapper (ch, nc, device, generator)."""
    d = _config(cfg)
    if task is None:
        if d.get("anchors") is None:
            task = "semantic"
        else:
            task = "segment" if str(d["head"][-1][2]) == "Segment" else "detect"
    if task == "classify":
        raise NotImplementedError("ClassificationModel is not ported yet: ROADMAP item 6f")
    return {"detect": DetectionModel, "segment": SegmentationModel,
            "semantic": SemanticSegModel}[task](d, **kw)
