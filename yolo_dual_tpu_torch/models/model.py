"""Graph walker, DetectionModel, SegmentationModel, SemanticSegModel,
ClassificationModel and build_model (port of yolo_dual_tpu/models/model.py;
reference models/yolo.py:109-296).

The space-to-depth blocked stem that the JAX `fuse()` applies on its own
(nn/blocked.py) is a TPU layout rewrite of the same math and is not ported:
`fuse()` here only folds each Conv's BatchNorm.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from yolo_dual_tpu_torch.models.compiler import (LayerSpec, ModelSpec, build_module, parse_config,
                                                 with_strides)
from yolo_dual_tpu_torch.models.heads import Detect, DetectAux
from yolo_dual_tpu_torch.nn.common import Conv, Sum, frozen_batch_stats, resize_bilinear
from yolo_dual_tpu_torch.nn.attention import AttentionConv, AttentionStem
from yolo_dual_tpu_torch.nn.dcn import C2f_DCN, DCNv2, DCNv3
from yolo_dual_tpu_torch.nn.spp import FixedProfileBatchNorm2d
from yolo_dual_tpu_torch.nn.torchvision_backbones import ConvNeXtBlock
from yolo_dual_tpu_torch.parallel import spatial
from yolo_dual_tpu_torch.utils.general import (LOGGER, find_cfg, intersect_dicts, load_config,
                                               select_device)

_HEADS = ("Detect", "Segment", "DetectAux")
# Registry names whose modules run on a rank's band inside parallel/spatial.py:spatial: their
# convolutions are Conv's and their pools max_pool_same's, which exchange halo rows; DCNv3
# gathers its sampling's input itself (nn/dcn.py). A channel Concat and an integer nearest
# Upsample never mix rows, nor do the heads' 1x1 convs. Every other layer runs gathered.
_ROW_LOCAL = frozenset({"Conv", "Bottleneck", "C3", "SPPF", "Proto", "C3_DCNV3"})
# Shape-only rows that `remat_layers` never wraps: they keep no activations of their own
# (JAX models/model.py:GraphModel._NO_REMAT); nor does it wrap the heads.
_NO_REMAT = frozenset({"Concat", "Upsample", "nn.Upsample", "Contract", "Expand", "Sum",
                       "MaxPool2d", "nn.MaxPool2d", "nn.ZeroPad2d", "nn.Softmax",
                       "nn.BatchNorm2d"})


def remat_rows(spec: ModelSpec, remat_layers) -> frozenset:
    """The indices of the rows `remat_layers` wraps (JAX models/model.py:_walk):
    True every row but the heads and the shape-only rows of `_NO_REMAT`, a
    tuple of indices those of its rows, False none."""
    if not remat_layers:
        return frozenset()
    every = remat_layers is True
    return frozenset(layer.i for layer in spec.layers
                     if (every or layer.i in remat_layers)
                     and layer.name not in _NO_REMAT and layer.name not in _HEADS)


def _row_local(layer: LayerSpec, mod: nn.Module) -> bool:
    if layer.name in _ROW_LOCAL or layer.name in _HEADS:
        return True
    if layer.name == "Concat":
        return getattr(mod, "d", None) == 1 and not getattr(mod, "align", True)
    if layer.name in ("Upsample", "nn.Upsample"):
        sf = getattr(mod, "scale_factor", None)
        return (getattr(mod, "mode", None) == "nearest" and mod.size is None and sf is not None
                and float(sf).is_integer())
    return False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _rebuild(tree, tensors):
    """`tree` with its tensors replaced, in order, by those of the iterator `tensors`."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    return tree


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


class GraphModel(nn.Module):
    """Walks a compiled ModelSpec (reference BaseModel._forward_once,
    models/yolo.py:114-125). Layer i is `self.model[i]`, so parameter names are
    the reference's `model.{i}.…`. Every BatchNorm takes the spec's profile
    (`spec.bn_profile`) but RFB's, which keep their own (nn/spp.py:BasicConv).

    `remat_layers` (JAX's GraphModel.remat_layers): in training, the rows it
    names (`remat_rows`: True every compute row, a tuple of layer indices
    those rows) recompute their forward in the backward instead of keeping
    their internal activations, each copy of a repeated row on its own
    (torch.utils.checkpoint; `_call`). The gradients, the loss and the
    BatchNorm statistics are those of the plain step; eval forwards are
    unchanged."""

    def __init__(self, spec: ModelSpec, remat_layers=False):
        super().__init__()
        self.spec = spec
        self.save = frozenset(spec.save)
        rows = remat_rows(spec, remat_layers)
        self.model = nn.ModuleList(build_module(layer, remat=layer.i in rows)
                                   for layer in spec.layers)
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
        """Under parallel/spatial.py:spatial with more than one band, the walk
        runs on this rank's band of rows. A layer of `_row_local` runs on its
        bands; any other gathers its input's rows over the space group, runs
        on the whole map and keeps its own rows of the output (its own rows'
        share of the gradient goes back, summed over the group). The head's
        outputs are gathered whole on every space rank, then decoded; a last
        layer without rows (Classify) leaves each rank its 1/sp share of the
        output's gradient. The input's height (the band's times sp) must be a
        multiple of sp x `largest_stride`. Without a mesh every gather, keep
        and share is the identity."""
        mesh = spatial.space_mesh()
        if mesh is not None:
            spatial.check_height(x.shape[2] * mesh.sp, mesh, self.largest_stride())
            self._log_gathered(mesh)
        y, out, rows = [], x, True  # rows: the last output is this rank's band
        for layer, mod in zip(self.spec.layers, self.model):
            if mesh is not None and not rows:
                raise ValueError(f"spatial partitioning: layer {layer.i} {layer.name} follows "
                                 "a layer whose output has no rows to split")
            f = layer.f
            if isinstance(f, tuple):
                inp = [out if j == -1 else y[j] for j in f]
            else:
                inp = out if f == -1 else y[f]
            if layer.name in _HEADS:
                raw = _map(lambda t: spatial.gather_rows(t, dim=2, site="head"),
                           mod(inp, decode=False))
                out, rows = (mod.decoded(raw) if decode else raw), None
            elif mesh is None or _row_local(layer, mod):
                out = self._call(mod, inp)
            else:
                inp = _map(lambda t: spatial.gather_rows(t, dim=2, sum_grads=True,
                                                         site=f"layer {layer.name}"), inp)
                with spatial.whole_maps():
                    out = self._call(mod, inp)
                if all(t.ndim == 4 for t in _tensors(out)):
                    out = _map(lambda t: spatial.keep_rows(t, dim=2), out)
                else:
                    out, rows = _map(spatial.share_grad, out), None
            y.append(out if layer.i in self.save else None)
        if mesh is not None and rows:
            out = _map(lambda t: spatial.gather_rows(t, dim=2, site="output"), out)
        return out

    def _call(self, mod: nn.Module, inp):
        """`mod(inp)`; in training, for a module built with `remat`, under
        torch.utils.checkpoint (non-reentrant): the backward recomputes the
        forward, each copy of a repeated row on its own, and the recompute
        runs under the spatial context of the call (this rank's bands, or the
        whole maps of a gathered layer) with the BatchNorm statistics frozen,
        so they are updated once, by the call itself."""
        if not (self.training and getattr(mod, "remat", False)):
            return mod(inp)
        mesh = spatial.space_mesh()  # None on whole maps (a gathered layer, or no mesh)

        @contextlib.contextmanager
        def recompute(m):
            with frozen_batch_stats(m), spatial.spatial(mesh):
                yield

        def run(m, x):  # the tensors as arguments: checkpoint reads their devices
            return checkpoint(lambda *t: m(_rebuild(x, iter(t))), *_tensors(x),
                              use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), recompute(m)))
        if isinstance(mod, nn.Sequential):
            for m in mod:
                inp = run(m, inp)
            return inp
        return run(mod, inp)

    def _log_gathered(self, mesh):
        """Logs once a model which layers run gathered over `mesh`'s bands."""
        if getattr(self, "_logged_gathered", False):
            return
        self._logged_gathered = True
        gathered = [f"{layer.i} {layer.name}" for layer, mod in zip(self.spec.layers, self.model)
                    if not _row_local(layer, mod)]
        LOGGER.info(f"spatial partitioning over {mesh.sp} bands: layers run gathered: "
                    f"{', '.join(gathered) or 'none'}")

    def largest_stride(self) -> int:
        """The input's rows over the fewest rows of any layer's map, from a
        forward at 1024 px on the meta device (shapes only)."""
        if getattr(self, "_largest_stride", None) is None:
            s, rows = 1024, []
            with torch.device("meta"):
                probe = GraphModel(self.spec).eval()
                x = torch.empty(1, self.spec.ch_in, s, s)
            for m in probe.model:
                m.register_forward_hook(lambda mod, args, out: rows.extend(
                    t.shape[2] for t in _tensors(out) if t.ndim == 4))
            with torch.no_grad(), spatial.whole_maps():
                probe._walk(x, decode=False)
            self._largest_stride = s // min(rows)
        return self._largest_stride

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
    if head.name == "DetectAux":
        levels = levels[:len(levels) // 2]  # the lead head's levels
    return with_strides(spec, [s // lvl.shape[2] for lvl in levels])  # lvl: (bs, na, ny, nx, no)


def init_weights(model: nn.Module, generator: torch.Generator):
    """Random weights from `generator` (a CPU generator): conv, transposed
    conv and linear weights N(0, 1/fan_in), as flax's lecun_normal init (a
    transposed conv's fan-in is JAX's, k·k·c2), and so C2f_DCN's
    deformable weights; DCNv2's weight U(±1/sqrt(cin·k²)) (JAX
    nn/dcn.py:289-295); the attention blocks' `rel_*` and `emb_*` N(0, 1), as
    flax's normal(1.0); zero biases; identity BatchNorms with fresh running
    stats and identity LayerNorms; ConvNeXt's layer scale `gamma` 1e-6; zero
    DCNv3 offset and mask heads and zero DCNv2 `conv_offset_mask`,
    as JAX initializes them (every sample on its grid point, uniform mask);
    Sum's gates at JAX's -arange(1, n) / 2."""
    def lecun(w):
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w[0].numel()))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                lecun(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(1e-6)
            elif isinstance(m, DCNv2):  # JAX: std over the input's channels, not a group's
                std = 1 / math.sqrt(m.weight[0].numel() * m.g)
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * std)
                m.bias.zero_()
            elif isinstance(m, C2f_DCN):
                for i in range(m.n):
                    lecun(getattr(m, f"m_{i}_dcn_weight"))
            elif isinstance(m, Sum) and m.w is not None:
                m.w.copy_(-torch.arange(1.0, m.w.numel() + 1) / 2)
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


def initialize_detect_biases(model: GraphModel, cf=None):
    """Prior init of the Detect conv biases (reference models/yolo.py:253-261);
    of DetectAux's lead head only, as JAX's (JAX models/model.py:139). The
    class biases take log(0.6 / (nc - 0.99999)), or with the class
    frequencies `cf` (nc counts) log(cf / cf.sum())."""
    head = model.model[-1]
    if isinstance(head, DetectAux):
        head = head.lead
    if not isinstance(head, Detect):
        return
    with torch.no_grad():
        for conv, s in zip(head.m, head.strides):
            b = conv.bias.view(head.na, -1)
            b[:, 4] += math.log(8 / (640 / s) ** 2)
            if cf is None:
                b[:, 5:5 + head.nc] += math.log(0.6 / (head.nc - 0.99999))
            else:
                cf = torch.as_tensor(cf, dtype=torch.float64)
                b[:, 5:5 + head.nc] = (b[:, 5:5 + head.nc].double()
                                       + torch.log(cf / cf.sum()).to(b.device)).to(b.dtype)


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
    ...), as JAX's. `anchors` replaces the config's anchors and `verbose`
    logs the compiled layers (models/compiler.py:parse_config), as JAX's
    BaseModel does (JAX models/model.py:172). `remat_layers` (False, True or a
    tuple of layer indices) recomputes those rows in the backward in training
    (GraphModel).
    """

    def __init__(self, cfg="yolov5s.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None, anchors=None,
                 verbose: bool = False, remat_layers=False):
        dev = select_device(device)
        spec = _probe_strides(parse_config(_config(cfg), ch=ch, nc=nc, anchors_override=anchors,
                                           verbose=verbose))
        with torch.device("meta"):
            super().__init__(spec, remat_layers)
        self.to_empty(device=dev)
        self.nc = spec.nc
        self.names = {i: str(i) for i in range(spec.nc)}
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        initialize_detect_biases(self)


class SegmentationModel(DetectionModel):
    """Instance-segmentation model: a DetectionModel whose config ends in a
    Segment head (default "yolov5s-seg.json")."""

    def __init__(self, cfg="yolov5s-seg.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None, anchors=None,
                 verbose: bool = False, remat_layers=False):
        super().__init__(cfg, ch=ch, nc=nc, device=device, generator=generator,
                         anchors=anchors, verbose=verbose, remat_layers=remat_layers)


class SemanticSegModel(GraphModel):
    """Dense semantic segmentation (JAX models/model.py:326-345), compiled
    from a semantic config (a dict, a path, or the name of one of the
    package's JSON copies, e.g. "resnet50.json").

    forward(x) takes (b, 3, H, W) float images in [0, 1] and returns the
    (b, nc, H, W) class scores: where the graph's output has another size
    (resnet50.json: half the input), it is resized bilinearly to the input's.
    Built on the meta device and materialized on `device`, weights drawn
    from `generator` (default: a CPU generator seeded 0); BatchNorms carry
    torch's defaults (eps 1e-5, momentum 0.1). `remat_layers` as
    DetectionModel's.
    """

    def __init__(self, cfg="resnet50.json", ch: int = 3, nc: Optional[int] = None,
                 device="cuda", generator: Optional[torch.Generator] = None, anchors=None,
                 verbose: bool = False, remat_layers=False):
        dev = select_device(device)
        spec = parse_config(_config(cfg), ch=ch, nc=nc, anchors_override=anchors,
                            verbose=verbose)
        if spec.style != "semantic":
            raise ValueError("SemanticSegModel needs a semantic config (no anchors); "
                             "use SegmentationModel for detect-style configs")
        with torch.device("meta"):
            super().__init__(spec, remat_layers)
        self.to_empty(device=dev)
        self.nc = spec.nc
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x):
        out = self._walk(x, decode=False)
        mesh = spatial.space_mesh()  # the walk returns the whole map on every space rank
        return resize_bilinear(out, (x.shape[-2] * (mesh.sp if mesh else 1), x.shape[-1]))


class ClassificationModel(GraphModel):
    """A classifier: the first `cutoff` layers of a compiled config and a
    `Classify` head of `nc` classes (reference models/yolo.py:273-296; JAX
    models/model.py:348). `cfg` is a dict, a path or the name of a JSON copy
    ("yolov5s.json", cutoff 10: YOLOv5s-cls), or classify.train's
    `build_classifier` config of a torchvision family. `save` keeps the
    indices below the cutoff; `stride` is [32]. The graph runs under the
    detect BatchNorm profile (eps 1e-3, momentum 0.03), as JAX's classify
    style does; the torchvision stages keep their own. Built on the meta
    device and materialized on `device`, weights drawn from `generator`
    (default: a CPU generator seeded 0); `dropout` > 0 puts nn.Dropout
    before the head's Linear.
    """

    def __init__(self, cfg="yolov5s.json", nc: int = 1000, cutoff: int = 10,
                 dropout: float = 0.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        dev = select_device(device)
        d = _config(cfg)
        base = parse_config(d, ch=3)
        layers = list(base.layers[:cutoff])
        i = len(layers)
        kw = (("c2", nc),) + ((("dropout", float(dropout)),) if dropout else ())
        layers.append(LayerSpec(i=i, f=-1, n=1, name="Classify", kwargs=kw, c1=layers[-1].c2,
                                c2=nc))
        spec = dataclasses.replace(base, layers=tuple(layers), nc=nc,
                                   save=tuple(s for s in base.save if s < i),
                                   out_ch=tuple(layer.c2 for layer in layers), anchors=(),
                                   strides=(), style="classify")
        with torch.device("meta"):
            super().__init__(spec)
        self.to_empty(device=dev)
        self.yaml, self.cutoff, self.dropout = d, cutoff, dropout
        self.nc = nc
        self.names = {j: str(j) for j in range(nc)}
        self.stride = [32]
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))


@torch.no_grad()
def reshape_classifier_output(model: ClassificationModel, nc: int,
                              generator: Optional[torch.Generator] = None) -> ClassificationModel:
    """The classifier `model` at `nc` classes (reference
    utils/torch_utils.py:66-87; JAX models/model.py:372): rebuilt on its
    device, every tensor whose name and shape still match copied over, so
    only the head's `linear` is drawn anew (from `generator`)."""
    if nc == model.nc:
        return model
    new = ClassificationModel(model.yaml, nc=nc, cutoff=model.cutoff, dropout=model.dropout,
                              device=next(model.parameters()).device, generator=generator)
    own = new.state_dict()
    for k, v in intersect_dicts(model.state_dict(), own).items():
        own[k].copy_(v)
    return new


TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, "lr", None)
TTA_PAD = 0.447  # the ImageNet-mean grey the reference pads scaled images with


def scale_img(img: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """An NCHW batch resized by `ratio` (JAX's antialiased bilinear resize)
    and padded at the bottom and right with TTA_PAD to a multiple of `gs`
    (JAX models/model.py:404 scale_img_nhwc; reference
    utils/torch_utils.py:297-308)."""
    if ratio == 1.0:
        return img
    h, w = img.shape[2:]
    sh, sw = int(h * ratio), int(w * ratio)
    out = resize_bilinear(img, (sh, sw))
    ph, pw = math.ceil(h * ratio / gs) * gs, math.ceil(w * ratio / gs) * gs
    return F.pad(out, (0, pw - sw, 0, ph - sh), value=TTA_PAD)


def forward_augment(model: GraphModel, x: torch.Tensor):
    """Test-time augmentation (JAX models/model.py:419; reference
    models/yolo.py:206-235): the eval forward at scales TTA_SCALES with
    flips TTA_FLIPS (lr flips the width, dim 3), each pass's decoded boxes
    descaled and deflipped, the identity pass' largest-stride level and the
    last pass' smallest-stride level clipped off, all concatenated. Returns
    (predictions (b, N, no), the identity pass' protos, or None for a
    detect head)."""
    w = x.shape[3]
    gs = int(max(model.spec.strides))
    nl = len(model.spec.strides) or 3
    ys, protos0 = [], None
    for s, f in zip(TTA_SCALES, TTA_FLIPS):
        xi = scale_img(x.flip(3) if f == "lr" else x, s, gs)
        out = model(xi, decode=True)
        pred = out[0]
        if len(out) == 3 and s == 1.0 and f is None:  # Segment: (pred, protos, raw)
            protos0 = out[1]
        px, py, pwh = pred[..., 0:1] / s, pred[..., 1:2] / s, pred[..., 2:4] / s
        if f == "lr":
            px = w - px
        ys.append(torch.cat([px, py, pwh, pred[..., 4:]], -1))
    g = sum(4 ** k for k in range(nl))
    ys[0] = ys[0][:, :-(ys[0].shape[1] // g)]
    ys[-1] = ys[-1][:, (ys[-1].shape[1] // g) * 4 ** (nl - 1):]
    return torch.cat(ys, 1), protos0


def build_model(cfg, task: Optional[str] = None, **kw) -> GraphModel:
    """The model of a config, its wrapper chosen from the config as JAX's
    build_model chooses it (JAX models/model.py:463): no anchors -> semantic,
    a last head row `Segment` -> segment, else detect. `task` overrides
    ("classify": ClassificationModel, whose `kw` are nc, cutoff, dropout,
    device, generator); `kw` goes to the wrapper (ch, nc, device, generator,
    remat_layers, ...)."""
    d = _config(cfg)
    if task is None:
        if d.get("anchors") is None:
            task = "semantic"
        else:
            task = "segment" if str(d["head"][-1][2]) == "Segment" else "detect"
    return {"detect": DetectionModel, "segment": SegmentationModel,
            "semantic": SemanticSegModel, "classify": ClassificationModel}[task](d, **kw)
