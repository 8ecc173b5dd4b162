"""Model-config compiler (port of yolo_dual_tpu/models/compiler.py).

Compiles a config dict (`nc / depth_multiple / width_multiple / anchors /
backbone / head`, rows `[from, number, module, args]`, reference
models/yolo.py:299-382 parse_model) into a static `ModelSpec`, and builds torch
modules from it through an explicit registry. Both dialects of the JAX
compiler are ported: 'detect' (the yolov5{n,s,m,l,x}-seg configs, the detect
zoo of `models/`, `hub/`, `spp/` and `attention/`, the DCNv3 blocks
`C3_DCNV3`, `DCNV3_YoLo` and the DCNv2 ones of yolov5n-DCN, the 36
torchvision stages `<family>{1,2,3}` of the `backbone/` configs, whose
declared width is not scaled, `Classify`, the names no shipped config uses
(DWConv, Focus, CrossConv, BottleneckCSP, C3x, C3SPP, MixConv2d, Contract,
Expand, Sum, nn.BatchNorm2d, nn.ConvTranspose2d, DWConvTranspose2d), and
AuxOTA's rule: a Detect row over twice as many maps as anchor levels is a
DetectAux, its strides those of the first half) and
'semantic' (the ResNet, ResNet U-Net, VGG16 and YOLO configs: the `number`
column ignored, C3 rows read their repeat from args[1], C2f / C2f_DCN / C3k2
rows from int(args[1]), no width scaling, relu by default, aligning Concats).

Unlike the JAX spec, each layer records its input channels `c1`, because torch
modules are built with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch.nn as nn

from yolo_dual_tpu_torch.nn.torchvision_backbones import STAGE_OUT
from yolo_dual_tpu_torch.utils.general import LOGGER, make_divisible


def _freeze(x):
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    return x


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    i: int                                  # layer index
    f: Union[int, Tuple[int, ...]]          # input layer index/indices (-1 = previous)
    n: int                                  # sequential repeats of the whole module
    name: str                               # registry module name
    kwargs: Tuple[Tuple[str, Any], ...]     # frozen kwargs for the module constructor
    c1: Union[int, Tuple[int, ...]]         # input channels (a tuple for multi-input rows)
    c2: int                                 # output channels

    def kw(self) -> dict:
        return dict(self.kwargs)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    layers: Tuple[LayerSpec, ...]
    nc: int
    ch_in: int = 3
    save: Tuple[int, ...] = ()
    out_ch: Tuple[int, ...] = ()
    anchors: Tuple[Tuple[float, ...], ...] = ()
    strides: Tuple[int, ...] = ()
    default_act: Optional[str] = None
    style: str = "detect"

    @property
    def bn_profile(self) -> Tuple[float, float]:
        """(eps, torch momentum) of the graph's BatchNorms: torch's defaults
        on the semantic path, the reference's initialize_weights profile on
        the detect and classify paths (JAX models/model.py:57-60)."""
        from yolo_dual_tpu_torch.nn import common as C
        if self.style == "semantic":
            return C.SEMANTIC_BN_EPS, C.SEMANTIC_BN_MOMENTUM
        return C.BN_EPS, C.BN_MOMENTUM


# ---------------------------------------------------------------------------
# Module registry: name -> make(c1, kwargs) -> nn.Module
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Callable[..., nn.Module]] = {}


def _populate_registry():
    if REGISTRY:
        return
    from yolo_dual_tpu_torch.models import heads as H
    from yolo_dual_tpu_torch.nn import attention as A
    from yolo_dual_tpu_torch.nn import backbones as B
    from yolo_dual_tpu_torch.nn import common as C
    from yolo_dual_tpu_torch.nn import dcn as D
    from yolo_dual_tpu_torch.nn import spp as S
    from yolo_dual_tpu_torch.nn import torchvision_backbones as T

    for nm, cls in {"Conv": C.Conv, "DWConv": C.DWConv, "Bottleneck": C.Bottleneck, "C3": C.C3,
                    "BottleneckCSP": C.BottleneckCSP, "CrossConv": C.CrossConv, "C3x": C.C3x,
                    "C3SPP": C.C3SPP, "Focus": C.Focus, "MixConv2d": C.MixConv2d,
                    "nn.ConvTranspose2d": C.ConvTranspose,
                    "DWConvTranspose2d": C.DWConvTranspose2d,
                    "C3Conv": C.C3Conv, "SPPF": C.SPPF, "Proto": C.Proto,
                    "C2f": C.C2f, "C3k2": C.C3k2, "GAM": C.GAM,
                    "SPP": C.SPP, "GhostConv": C.GhostConv,
                    "GhostBottleneck": C.GhostBottleneck, "C3Ghost": C.C3Ghost,
                    "TransformerBlock": C.TransformerBlock, "C3TR": C.C3TR,
                    "SimConv": S.SimConv, "SimSPPF": S.SimSPPF, "ASPP": S.ASPP, "RFB": S.RFB,
                    "SPPCSPC": S.SPPCSPC, "SPPCSPC_group": S.SPPCSPC_group,
                    "SimCSPSPPF": S.SimCSPSPPF,
                    "AttentionConv": A.AttentionConv, "AttentionStem": A.AttentionStem,
                    "DCNv2": D.DCNv2, "C3_DCN": D.C3_DCN, "C2f_DCN": D.C2f_DCN,
                    "DCNV3_YoLo": D.DCNV3_YoLo, "C3_DCNV3": D.C3_DCNV3,
                    "ResNetStem": B.ResNetStem, "ResNetLayer": B.ResNetLayer,
                    "VGGBlock": B.VGGBlock, "SegmentHead": B.SegmentHead}.items():
        REGISTRY[nm] = lambda c1, kw, cls=cls: cls(c1, **kw)
    for nm, cls in {"Concat": C.Concat, "Upsample": C.Upsample,
                    "nn.Upsample": C.Upsample, "nn.Softmax": nn.Softmax,
                    "MaxPool2d": B.MaxPool2d, "nn.MaxPool2d": B.MaxPool2d,
                    "nn.ZeroPad2d": C.ZeroPad2d, "Contract": C.Contract, "Expand": C.Expand,
                    "Sum": C.Sum}.items():
        REGISTRY[nm] = lambda c1, kw, cls=cls: cls(**kw)
    REGISTRY["nn.BatchNorm2d"] = lambda c1, kw: C.BatchNormLayer(c1)
    for nm, cls in {"Detect": H.Detect, "Segment": H.Segment, "DetectAux": H.DetectAux}.items():
        REGISTRY[nm] = lambda c1, kw, cls=cls: cls(ch=c1, **kw)
    REGISTRY["Classify"] = lambda c1, kw: C.Classify(c1, **kw)
    for nm in _TV_STAGES:
        REGISTRY[nm] = lambda c1, kw, nm=nm: T.build_stage(nm, c1, **kw)


def build_module(layer: LayerSpec) -> nn.Module:
    """Instantiate the module of one compiled row (an nn.Sequential of
    `layer.n` copies when the row repeats a module the compiler could not fold)."""
    _populate_registry()
    if layer.name not in REGISTRY:
        raise KeyError(f"Module {layer.name!r} is not registered. Known: {sorted(REGISTRY)}")
    build = REGISTRY[layer.name]
    if layer.n > 1:
        return nn.Sequential(*(build(layer.c1 if r == 0 else layer.c2, layer.kw())
                               for r in range(layer.n)))
    return build(layer.c1, layer.kw())


# Modules whose first arg is c2 (width-scaled on the detect path).
_CONVLIKE = {"Conv", "Bottleneck", "SPPF", "C3", "C3Conv", "C2f", "C3k2", "DCNv2", "C3_DCN",
             "C2f_DCN", "DCNV3_YoLo", "C3_DCNV3", "SPP", "GhostConv", "GhostBottleneck",
             "C3Ghost", "C3TR", "SimConv", "SimSPPF", "ASPP", "RFB", "SPPCSPC", "SPPCSPC_group",
             "SimCSPSPPF", "AttentionConv", "AttentionStem", "DWConv", "Focus", "CrossConv",
             "BottleneckCSP", "C3SPP", "C3x", "MixConv2d", "nn.ConvTranspose2d",
             "DWConvTranspose2d"}
# Modules whose repeat is an `n` kwarg (on the detect path the compiler
# inserts the row's repeat). As in the JAX compiler, C3_DCNV3 is not one of
# them: its row repeat stays a repeat of whole C3_DCNV3 modules, each with one
# inner bottleneck. On the semantic path C3_DCN keeps its args as they are
# ([c2, n], shortcut True); C2f, C2f_DCN and C3k2 take n = int(args[1]).
_REPEAT_AS_N = {"C3", "C3Conv", "C3_DCN", "C2f", "C2f_DCN", "C3k2", "C3TR", "C3Ghost",
                "BottleneckCSP", "C3x"}
# Modules whose output width is their first arg.
_C2_FIRST = {"ResNetStem", "ResNetLayer", "VGGBlock", "SegmentHead"}
_RESNET_LAYERS = {"ResNet50Layer": "bottleneck", "ResNet18Layer": "basic",
                  "ResNet34Layer": "basic"}
# The torchvision stages (nn/torchvision_backbones.py): args [c2], c2 never
# width-scaled, and 0 for "the stage's own width" (STAGE_OUT).
_TV_STAGES = frozenset(STAGE_OUT)


def _resolve(a, symbols: dict):
    """Resolve config arg strings the way parse_model's guarded eval does."""
    if isinstance(a, str):
        if a in symbols:
            return symbols[a]
        low = a.lower()
        if low == "none":
            return None
        if low == "true":
            return True
        if low == "false":
            return False
        try:
            return int(a)
        except ValueError:
            pass
        try:
            return float(a)
        except ValueError:
            pass
        return a  # e.g. 'nearest'
    return a


def _adapt_args(name: str, args: list, n: int, act) -> Tuple[dict, int]:
    """Map positional config args (c1 stripped) to module kwargs.
    Returns (kwargs, n_repeats_left)."""
    a = list(args)

    def actkw(kw):
        if act is not None and kw.get("act", True) is True:
            kw["act"] = act
        return kw

    if name in ("Conv", "SimConv", "DCNV3_YoLo", "DCNv2"):
        return actkw(dict(zip(["c2", "k", "s", "p", "g", "d", "act"], a))), n
    if name == "DWConv":
        return actkw(dict(zip(["c2", "k", "s", "d", "act"], a))), n
    if name == "Focus":
        return actkw(dict(zip(["c2", "k", "s", "p", "g", "act"], a))), n
    if name == "CrossConv":
        return dict(zip(["c2", "k", "s", "g", "e", "shortcut"], a)), n
    if name == "C3SPP":  # the repeat sits at position 2, after k (JAX's quirk, ROADMAP §C)
        return dict(zip(["c2", "k", "n", "shortcut", "g", "e"], a)), 1
    if name == "MixConv2d":
        kw = dict(zip(["c2", "k", "s", "equal_ch"], a))
        if "k" in kw:
            kw["k"] = tuple(kw["k"])
        return kw, n
    if name == "Sum":  # n is the input count, not a repeat: the row's repeat becomes 1
        return dict(zip(["n", "weight"], a)), 1
    if name in ("Contract", "Expand"):
        return {"gain": a[0] if a else 2}, n
    if name == "nn.BatchNorm2d":
        return {}, n
    if name in ("nn.ConvTranspose2d", "DWConvTranspose2d"):  # g stays 1 (ROADMAP §C)
        return dict(zip(["c2", "k", "s", "p"], a)), n
    if name == "GhostConv":
        return actkw(dict(zip(["c2", "k", "s", "g", "act"], a))), n
    if name == "GhostBottleneck":
        return dict(zip(["c2", "k", "s"], a)), n
    if name == "Bottleneck":
        return actkw(dict(zip(["c2", "shortcut", "g", "e"], a))), n
    if name in _REPEAT_AS_N:
        return actkw(dict(zip(["c2", "n", "shortcut", "g", "e"], a))), 1
    if name in ("SPPF", "SimSPPF", "SimCSPSPPF"):
        return actkw(dict(zip(["c2", "k"], a))), n
    if name in ("SPP", "SPPCSPC", "SPPCSPC_group"):
        kw = dict(zip(["c2", "k"] if name == "SPP" else ["c2", "n", "shortcut", "g", "e", "k"], a))
        if "k" in kw:
            kw["k"] = tuple(kw["k"])
        return kw, n
    if name == "ASPP":
        return dict(zip(["c2"], a)), n
    if name == "RFB":
        return dict(zip(["c2", "stride", "scale", "map_reduce", "vision", "groups"], a)), n
    if name in ("AttentionConv", "AttentionStem"):  # the reference's (c1, c2, k, s, p, groups)
        return dict(zip(["c2", "k", "s", "p", "groups"], a)), n
    if name == "TransformerBlock":
        return dict(zip(["c2", "num_heads", "num_layers"], a)), n
    if name in ("MaxPool2d", "nn.MaxPool2d"):
        return dict(zip(["k", "s", "p"], a)), n
    if name == "nn.ZeroPad2d":
        return {"padding": tuple(a[0])}, n
    if name in ("nn.Upsample", "Upsample"):
        return dict(zip(["size", "scale_factor", "mode"], a)), n
    if name == "Concat":
        return {"d": a[0] if a else 1}, n
    if name == "C3_DCNV3":  # the JAX compiler's default branch: c2 only
        return dict(zip(["c2"], a)), n
    if name == "nn.Softmax":
        return {"dim": a[0] if a else 1}, n
    if name == "GAM":
        return dict(zip(["c", "k", "s", "e"], a)), n
    if name in _TV_STAGES:
        return {"c2": a[0]}, n
    if name == "Classify":
        return dict(zip(["c2", "k", "s", "p", "g"], a)), n
    keys = {"ResNetStem": ["c2"], "ResNetLayer": ["c2", "n", "stride", "block"],
            "VGGBlock": ["c2", "n", "pool"], "SegmentHead": ["nc", "width"]}.get(name)
    if keys is not None:
        kw = dict(zip(keys, a))
        if act is not None:
            kw["act"] = act
        return kw, n
    _populate_registry()
    raise KeyError(f"Module {name!r} is not ported. Known: "
                   f"{sorted(set(REGISTRY) | set(_RESNET_LAYERS))}")


def _semantic_row(name: str, args: list, n: int):
    """The semantic dialect's row rewrites (JAX models/compiler.py:346-389):
    C3 becomes C3Conv with its repeat from args[1] (False -> 0 inner blocks),
    C2f, C2f_DCN and C3k2 take their repeat from int(args[1]) (True -> 1),
    ResNet{18,34,50}Layer become ResNetLayer with their block kind, and the
    `number` column is ignored, except on the ResNet rows, which keep it
    as JAX does. Every other row keeps its args: a C3_DCN row's [c2, n] zips
    to c2 and n with JAX's default shortcut=True. Returns (name, args, n)."""
    if name == "C3":
        inner = int(args[1]) if len(args) > 1 else 1
        shortcut = bool(args[2]) if len(args) > 2 else False
        return "C3Conv", [args[0], inner, shortcut] + list(args[3:]), 1
    if name in ("C2f", "C2f_DCN", "C3k2"):
        args = list(args)
        if len(args) > 1:
            args[1] = int(args[1])
        return name, args, 1
    if name in _RESNET_LAYERS:
        if len(args) != 3:
            raise ValueError(f"{name} args {args}: expected [c2, blocks, stride]")
        return "ResNetLayer", list(args) + [_RESNET_LAYERS[name]], n
    return name, args, 1


def parse_config(d: dict, ch: int = 3, nc: Optional[int] = None) -> ModelSpec:
    """Compile a model-config dict into a ModelSpec (reference models/yolo.py:299-382).
    A config without anchors, or with `compiler: semantic`, compiles in the
    semantic dialect; `compiler: classify` compiles in the detect dialect
    and keeps the detect BatchNorm profile."""
    style = d.get("compiler", "detect" if d.get("anchors") is not None else "semantic")
    if style not in ("detect", "semantic", "classify"):
        raise ValueError(f"unknown compiler dialect {style!r}; expected 'detect', 'semantic' "
                         "or 'classify'")
    semantic = style == "semantic"
    anchors = d.get("anchors")
    model_nc = nc if (nc is not None and nc != d.get("nc")) else d["nc"]
    gd = d.get("depth_multiple", 1.0)
    gw = d.get("width_multiple", 1.0)
    default_act = d.get("activation")
    if semantic and default_act is None:
        default_act = "relu"

    na = (len(anchors[0]) // 2) if isinstance(anchors, list) else (anchors or 0)
    no = na * (model_nc + 5)

    symbols = {"nc": model_nc, "anchors": anchors, "None": None}
    layers: list[LayerSpec] = []
    save: set[int] = set()
    chs = [ch]

    rows = list(d["backbone"]) + list(d["head"])
    for i, (f, n, name, args) in enumerate(rows):
        name = str(name)
        args = [_resolve(a, symbols) for a in args]
        if semantic:
            name, args, n = _semantic_row(name, args, n)
        n = max(round(n * gd), 1) if n > 1 else n
        c1 = chs[f] if isinstance(f, int) else tuple(chs[x] for x in f)

        if name in _CONVLIKE:
            c2 = args[0]
            if not semantic:
                if c2 != no:
                    c2 = make_divisible(c2 * gw, 8)
                args = [c2, *args[1:]]
                if name in _REPEAT_AS_N or name == "C3SPP":
                    args.insert(2 if name == "C3SPP" else 1, n)
                    n = 1
        elif name in _C2_FIRST or name == "Classify":
            c2 = args[0]
        elif name in _TV_STAGES:
            c2 = args[0] or STAGE_OUT[name]
        elif name == "Concat":
            c2 = sum(c1)
        elif name == "Contract":
            c2 = c1 * args[0] ** 2
        elif name == "Expand":
            c2 = c1 // args[0] ** 2
        elif name in ("Detect", "Segment"):
            c2 = 0
        elif name == "GAM":  # its width is the input's (JAX models/compiler.py:430-432)
            c2 = c1
            args = [c2, *args[1:]]
        else:
            c2 = c1 if isinstance(c1, int) else c1[0]

        if name in ("Detect", "Segment"):
            head_anchors = args[1]
            if name == "Detect" and isinstance(head_anchors, list) \
                    and len(f) == 2 * len(head_anchors):
                name = "DetectAux"  # the AuxOTA dual head (JAX models/compiler.py:439-449)
            if isinstance(head_anchors, int):
                # AutoAnchor placeholder: `anchors: 3` = 3 anchors per level
                head_anchors = [list(range(head_anchors * 2))] * len(f)
            n_str = len(f) // 2 if name == "DetectAux" else len(f)
            kwargs = {"nc": args[0], "anchors": _freeze(head_anchors),
                      "strides": tuple(2 ** (3 + j) for j in range(n_str))}
            if name == "Segment":
                kwargs["nm"] = args[2] if len(args) > 2 else 32
                kwargs["npr"] = make_divisible(args[3] * gw, 8) if len(args) > 3 else 256
        else:
            kwargs, n = _adapt_args(name, args, n, default_act)
            if name == "Concat" and semantic:
                kwargs["align"] = True

        fi = f if isinstance(f, int) else tuple(f)
        layers.append(LayerSpec(i=i, f=fi, n=n, name=name, kwargs=_freeze(kwargs), c1=c1, c2=c2))
        save.update(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)

    anchors_t = _freeze(anchors) if isinstance(anchors, list) else ()
    return ModelSpec(layers=tuple(layers), nc=model_nc, ch_in=ch, save=tuple(sorted(save)),
                     out_ch=tuple(chs), anchors=anchors_t, strides=(), default_act=default_act,
                     style=style)


def with_strides(spec: ModelSpec, strides: Sequence[int]) -> ModelSpec:
    """Return a copy of `spec` with head strides fixed and anchor order checked
    (reference utils/autoanchor.py check_anchor_order; anchors stay in pixels)."""
    layers = list(spec.layers)
    head = layers[-1]
    if head.name not in ("Detect", "Segment", "DetectAux"):
        return dataclasses.replace(spec, strides=tuple(strides))
    kw = dict(head.kwargs)
    anchors = [list(a) for a in kw["anchors"]]
    areas = [sum(a[j] * a[j + 1] for j in range(0, len(a), 2)) / (len(a) // 2) for a in anchors]
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if da and ds and (da > 0) != (ds > 0):
        LOGGER.info("Reversing anchor order to match stride order")
        anchors = anchors[::-1]
    kw["anchors"] = _freeze(anchors)
    kw["strides"] = tuple(int(s) for s in strides)
    layers[-1] = dataclasses.replace(head, kwargs=_freeze(kw))
    return dataclasses.replace(spec, layers=tuple(layers), strides=tuple(int(s) for s in strides))
