"""ONNX export with no dependency beyond numpy (port of
yolo_dual_tpu/io/onnx_export.py; reference models/common.py:320-624
DetectMultiBackend's ONNX path, whose exporter the reference lost).

Neither `onnx` nor `onnxscript` is installed, so torch's own exporter cannot
run; this module writes the ONNX protobuf wire format itself, as JAX's does
(ModelProto / GraphProto / NodeProto / TensorProto are small, stable
messages). It walks the port's compiled ModelSpec with the state_dict of a
conv+BN-folded copy of the model and emits the same NCHW graph as JAX's
writer, node for node and name for name: Conv / Sigmoid / Mul / Add / Concat /
MaxPool / Resize / Reshape / Transpose / Slice / Pow, opset 13. Input
`images` (1, 3, imgsz, imgsz) in [0, 1]; outputs the decoded `pred`
(1, N, no) and, for a Segment head, `protos` (NCHW), or, for a semantic graph,
`seg` (1, nc, imgsz, imgsz). cv2.dnn reads the files
(tests/test_torch_port_export.py).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from yolo_dual_tpu_torch.io.protowire import f_bytes as _f_bytes
from yolo_dual_tpu_torch.io.protowire import f_float as _f_float
from yolo_dual_tpu_torch.io.protowire import f_int as _f_int
from yolo_dual_tpu_torch.io.protowire import f_str as _f_str
from yolo_dual_tpu_torch.nn.common import BN_EPS

# ONNX messages (field numbers from onnx.proto), written with io/protowire.py

# onnx.TensorProto.DataType
FLOAT, INT64 = 1, 7
# onnx.AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_FLOATS, A_INTS = 1, 2, 3, 4, 6, 7


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int64:
        dt = INT64
    else:
        arr = arr.astype(np.float32)
        dt = FLOAT
    out = b""
    for d in arr.shape:
        out += _f_int(1, d)                      # dims
    out += _f_int(2, dt)                         # data_type
    out += _f_str(8, name)                       # name
    out += _f_bytes(9, arr.tobytes())            # raw_data
    return out


def _attr(name: str, value) -> bytes:
    out = _f_str(1, name)
    if isinstance(value, bool):
        out += _f_int(3, int(value)) + _f_int(20, A_INT)
    elif isinstance(value, int):
        out += _f_int(3, value) + _f_int(20, A_INT)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_int(20, A_FLOAT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_int(20, A_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, _tensor_proto("", value)) + _f_int(20, A_TENSOR)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        out += b"".join(_f_int(8, v) for v in value) + _f_int(20, A_INTS)
    elif isinstance(value, (list, tuple)):
        out += b"".join(_f_float(7, v) for v in value) + _f_int(20, A_FLOATS)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def _node_proto(op: str, inputs, outputs, attrs: Dict[str, Any]) -> bytes:
    out = b"".join(_f_str(1, i) for i in inputs)
    out += b"".join(_f_str(2, o) for o in outputs)
    out += _f_str(4, op)
    for k, v in attrs.items():
        out += _f_bytes(5, _attr(k, v))
    return out


def _value_info(name: str, shape, elem_type: int = FLOAT) -> bytes:
    dims = b""
    for d in shape:
        dims += _f_bytes(1, _f_int(1, d))        # TensorShapeProto.Dimension.dim_value
    tensor_type = _f_int(1, elem_type) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


class OnnxGraphBuilder:
    """Accumulates nodes/initializers; serializes a ModelProto (opset 13)."""

    def __init__(self, name: str = "yolo_dual_tpu"):
        self.name = name
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def tensor(self, arr: np.ndarray, hint: str = "w") -> str:
        name = self.fresh(hint)
        self.inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op: str, inputs, out: Optional[str] = None, **attrs) -> str:
        out = out or self.fresh(op.lower())
        self.nodes.append(_node_proto(op, list(inputs), [out], attrs))
        return out

    def serialize(self, inputs: Dict[str, tuple], outputs: Dict[str, tuple]) -> bytes:
        graph = b"".join(_f_bytes(1, n) for n in self.nodes)
        graph += _f_str(2, self.name)
        graph += b"".join(_f_bytes(5, i) for i in self.inits)
        graph += b"".join(_f_bytes(11, _value_info(k, v)) for k, v in inputs.items())
        graph += b"".join(_f_bytes(12, _value_info(k, v)) for k, v in outputs.items())
        opset = _f_str(1, "") + _f_int(2, 13)
        model = _f_int(1, 8)                      # ir_version 8
        model += _f_str(2, "yolo_dual_tpu")       # producer_name
        model += _f_bytes(7, graph)
        model += _f_bytes(8, opset)
        return model


# ---------------------------------------------------------------------------
# Graph construction from the fused ModelSpec + state_dict
# ---------------------------------------------------------------------------


def _np(x):
    return np.asarray(x, np.float32)


class _Exporter:
    """Emitters, one a module of the supported zoo. `p` is the module's
    subtree of the fused state_dict, nested by its dotted names
    (`p["cv1"]["conv"]["weight"]`); conv weights are OIHW as ONNX takes them."""

    def __init__(self, g: OnnxGraphBuilder, params: dict):
        self.g = g
        self.params = params

    # -- leaf emitters -------------------------------------------------------
    def act(self, x: str, act) -> str:
        if act is True or (isinstance(act, str) and act.lower() == "silu"):
            s = self.g.node("Sigmoid", [x])
            return self.g.node("Mul", [x, s])
        if act is False or act is None:
            return x
        key = str(act).lower()
        if key == "relu":
            return self.g.node("Relu", [x])
        if key in ("leakyrelu", "leaky_relu", "leaky"):
            return self.g.node("LeakyRelu", [x], alpha=0.1)
        if key == "hardswish":
            return self.g.node("HardSwish", [x])
        raise NotImplementedError(f"ONNX export: activation {act!r}")

    def conv(self, x: str, p: dict, kw: dict) -> str:
        """Fused Conv module: conv(+bias) then activation. p = {'conv': {...}}."""
        cp = p["conv"]
        w = self.g.tensor(_np(cp["weight"]))
        inputs = [x, w]
        if "bias" in cp:
            inputs.append(self.g.tensor(_np(cp["bias"])))
        k = kw.get("k", 1)
        k = (k, k) if isinstance(k, int) else tuple(k)
        s = kw.get("s", 1)
        s = (s, s) if isinstance(s, int) else tuple(s)
        d = int(kw.get("d", 1))
        pad = kw.get("p", None)
        if pad is None:
            kk = [d * (x_ - 1) + 1 for x_ in k] if d > 1 else list(k)
            pad = [x_ // 2 for x_ in kk]
        else:
            pad = [pad, pad] if isinstance(pad, int) else list(pad)
        groups = int(kw.get("g", 1))
        y = self.g.node("Conv", inputs, strides=list(s), group=groups,
                        dilations=[d, d], pads=[pad[0], pad[1], pad[0], pad[1]],
                        kernel_shape=list(k))
        if "bn" in p:   # an unfused model (the SavedModel writer's default)
            bn = p["bn"]
            y = self.g.node("BatchNormalization", [y] + [
                self.g.tensor(_np(bn[n])) for n in ("weight", "bias", "running_mean",
                                                     "running_var")], epsilon=BN_EPS)
        return self.act(y, kw.get("act", True))

    def bottleneck(self, x: str, p: dict, kw: dict, cin: int) -> str:
        c2 = kw["c2"]
        e = kw.get("e", 1.0)
        c_ = int(c2 * e)
        y = self.conv(x, p["cv1"], dict(c2=c_, k=1, act=kw.get("act", True)))
        y = self.conv(y, p["cv2"], dict(c2=c2, k=3, g=kw.get("g", 1),
                                        act=kw.get("act", True)))
        if kw.get("shortcut", True) and cin == c2:
            y = self.g.node("Add", [x, y])
        return y

    def c3(self, x: str, p: dict, kw: dict, cin: int) -> str:
        c2, n = kw["c2"], kw.get("n", 1)
        e = kw.get("e", 0.5)
        act = kw.get("act", True)
        c_ = int(c2 * e)
        y1 = self.conv(x, p["cv1"], dict(c2=c_, k=1, act=act))
        for i in range(n):
            y1 = self.bottleneck(y1, p["m"][str(i)],
                                 dict(c2=c_, e=1.0, g=kw.get("g", 1),
                                      shortcut=kw.get("shortcut", True), act=act),
                                 cin=c_)
        y2 = self.conv(x, p["cv2"], dict(c2=c_, k=1, act=act))
        cat = self.g.node("Concat", [y1, y2], axis=1)
        return self.conv(cat, p["cv3"], dict(c2=c2, k=1, act=act))

    def sppf(self, x: str, p: dict, kw: dict, cin: int) -> str:
        k = kw.get("k", 5)
        act = kw.get("act", True)
        y = self.conv(x, p["cv1"], dict(c2=cin // 2, k=1, act=act))
        pads = [k // 2] * 4
        m1 = self.g.node("MaxPool", [y], kernel_shape=[k, k], strides=[1, 1], pads=pads)
        m2 = self.g.node("MaxPool", [m1], kernel_shape=[k, k], strides=[1, 1], pads=pads)
        m3 = self.g.node("MaxPool", [m2], kernel_shape=[k, k], strides=[1, 1], pads=pads)
        cat = self.g.node("Concat", [y, m1, m2, m3], axis=1)
        return self.conv(cat, p["cv2"], dict(c2=kw["c2"], k=1, act=act))

    def upsample(self, x: str, kw: dict) -> str:
        sf = float(kw.get("scale_factor") or 2)
        scales = self.g.tensor(np.array([1.0, 1.0, sf, sf], np.float32), "scales")
        roi = self.g.tensor(np.zeros((0,), np.float32), "roi")
        mode = str(kw.get("mode") or "nearest")
        if mode in ("bilinear", "linear"):
            # half-pixel centres: the port's resize_bilinear at an upscale
            return self.g.node("Resize", [x, roi, scales], mode="linear",
                               coordinate_transformation_mode="half_pixel")
        return self.g.node("Resize", [x, roi, scales], mode="nearest",
                           coordinate_transformation_mode="asymmetric",
                           nearest_mode="floor")

    def resize_to_c(self, x: str, src_hw: tuple, dst_hw: tuple) -> str:
        """Bilinear half-pixel resize src_hw -> dst_hw: the semantic Concat's
        align step (nn/common.py Concat align=True). Scales, not sizes:
        cv2.dnn's ONNX importer reads the three-input Resize; the output size
        floor(in*scale) is exact at the zoo's ratios."""
        sf = (dst_hw[0] / src_hw[0], dst_hw[1] / src_hw[1])
        scales = self.g.tensor(np.array([1.0, 1.0, sf[0], sf[1]], np.float32),
                               "scales")
        roi = self.g.tensor(np.zeros((0,), np.float32), "roi")
        return self.g.node("Resize", [x, roi, scales], mode="linear",
                           coordinate_transformation_mode="half_pixel")

    def maxpool(self, x: str, k: int, s: int, p: int) -> str:
        return self.g.node("MaxPool", [x], kernel_shape=[k, k], strides=[s, s],
                           pads=[p, p, p, p])

    # -- semantic-zoo emitters (nn/backbones.py + C3Conv) --------------------
    def resnet_stem(self, x: str, p: dict, kw: dict) -> str:
        y = self.conv(x, p["conv"], dict(c2=kw["c2"], k=7, s=2, p=3,
                                         act=kw.get("act", "relu")))
        return self.maxpool(y, 3, 2, 1)

    def _resnet_block(self, x: str, p: dict, c2: int, stride: int, act,
                      block: str) -> str:
        if block == "bottleneck":
            mid = c2 // 4
            y = self.conv(x, p["conv1"], dict(c2=mid, k=1, p=0, act=act))
            y = self.conv(y, p["conv2"], dict(c2=mid, k=3, s=stride, p=1, act=act))
            y = self.conv(y, p["conv3"], dict(c2=c2, k=1, p=0, act=False))
        else:
            y = self.conv(x, p["conv1"], dict(c2=c2, k=3, s=stride, p=1, act=act))
            y = self.conv(y, p["conv2"], dict(c2=c2, k=3, p=1, act=False))
        if "downsample" in p:
            x = self.conv(x, p["downsample"], dict(c2=c2, k=1, s=stride, p=0,
                                                   act=False))
        return self.act(self.g.node("Add", [x, y]), act)

    def resnet_layer(self, x: str, p: dict, kw: dict) -> str:
        act = kw.get("act", "relu")
        c2, n = kw["c2"], kw.get("n", 1)
        block = kw.get("block", "bottleneck")
        x = self._resnet_block(x, p["layer"]["0"], c2, kw.get("stride", 1), act, block)
        for i in range(1, n):
            x = self._resnet_block(x, p["layer"][str(i)], c2, 1, act, block)
        return x

    def vgg_block(self, x: str, p: dict, kw: dict) -> str:
        act = kw.get("act", "relu")
        for i in range(kw.get("n", 2)):
            x = self.conv(x, p[f"conv{i}"], dict(c2=kw["c2"], k=3, p=1, act=act))
        if kw.get("pool", True):
            x = self.maxpool(x, 2, 2, 0)
        return x

    def resize_ac(self, x: str, src_hw: tuple, dst_hw: tuple) -> str:
        """align_corners=True bilinear (nn/backbones.py resize_bilinear_ac,
        SegmentHead's lateral upsampling)."""
        sf = (dst_hw[0] / src_hw[0], dst_hw[1] / src_hw[1])
        scales = self.g.tensor(np.array([1.0, 1.0, sf[0], sf[1]], np.float32),
                               "scales")
        roi = self.g.tensor(np.zeros((0,), np.float32), "roi")
        return self.g.node("Resize", [x, roi, scales], mode="linear",
                           coordinate_transformation_mode="align_corners")

    def segment_head(self, xs: List[str], p: dict, kw: dict,
                     sizes: List[tuple]) -> str:
        """U-Net-style semantic head (nn/backbones.py SegmentHead: lateral
        1x1 convs -> align-corners upsample to the finest scale -> concat ->
        3x3 -> 1x1 logits)."""
        act = kw.get("act", "relu")
        width = kw.get("width", 128)
        target = sizes[0]
        outs = []
        for i, (x, hw) in enumerate(zip(xs, sizes)):
            f = self.conv(x, p[f"lateral{i}"], dict(c2=width, k=1, act=act))
            if hw != target:
                f = self.resize_ac(f, hw, target)
            outs.append(f)
        y = self.g.node("Concat", outs, axis=1)
        y = self.conv(y, p["final0"], dict(c2=2 * width, k=3, p=1, act=act))
        return self.conv(y, p["final1"], dict(c2=kw["nc"], k=1, act=False))

    def c3conv(self, x: str, p: dict, kw: dict) -> str:
        """C3 skeleton with plain-conv inners (nn/common.py C3Conv; n may be
        0, the split and merge alone)."""
        c2, n = kw["c2"], kw.get("n", 1)
        act = kw.get("act", "relu")
        c_ = int(c2 * kw.get("e", 0.5))
        y1 = self.conv(x, p["cv1"], dict(c2=c_, k=1, act=act))
        for i in range(n):
            y1 = self.conv(y1, p["m"][str(i)], dict(c2=c_, k=3, p=1, act=act))
        y2 = self.conv(x, p["cv2"], dict(c2=c_, k=1, act=act))
        cat = self.g.node("Concat", [y1, y2], axis=1)
        return self.conv(cat, p["cv3"], dict(c2=c2, k=1, act=act))

    def linear(self, x: str, p: dict) -> str:
        """nn.Linear over the channels of an NCHW map: a 1x1 Conv."""
        w = self.g.tensor(_np(p["weight"])[:, :, None, None])
        return self.g.node("Conv", [x, w, self.g.tensor(_np(p["bias"]))], strides=[1, 1],
                           group=1, dilations=[1, 1], pads=[0, 0, 0, 0], kernel_shape=[1, 1])

    def dcnv3(self, x: str, p: dict, c: int, k: int, pad: int, group: int) -> str:
        """nn/dcn.py DCNv3 on an NCHW map: the projections as 1x1 Convs, the
        depthwise Conv, and one `DCNv3` node (the mask's softmax over each
        group's k*k points, then the deformable sampling) that the TF
        lowering (io/tf_graph.py) expands into gathers."""
        proj = self.linear(x, p["input_proj"])
        x1 = self.conv(x, p["dw_conv"], dict(c2=c, k=k, g=c))
        offset = self.linear(x1, p["offset"])
        mask = self.linear(x1, p["mask"])
        y = self.g.node("DCNv3", [proj, offset, mask], kernel=k, stride=1, pad=pad,
                        dilation=1, group=group, offset_scale=1.0)
        return self.linear(y, p["output_proj"])

    def c3_dcnv3(self, x: str, p: dict, kw: dict) -> str:
        """nn/dcn.py C3_DCNV3: C3 whose bottlenecks' second conv is a 1x1 Conv
        then DCNv3 (DCNV3_YoLo, k 3, pad 1)."""
        c2, n = kw["c2"], kw.get("n", 1)
        c_ = int(c2 * kw.get("e", 0.5))
        y1 = self.conv(x, p["cv1"], dict(c2=c_, k=1))
        for i in range(n):
            b = p["m"][str(i)]
            y = self.conv(y1, b["cv1"], dict(c2=c_, k=1))
            y = self.conv(y, b["cv2"]["conv"], dict(c2=c_, k=1))
            y = self.dcnv3(y, b["cv2"]["dcnv3"], c_, 3, 1, kw.get("g", 1))
            y1 = self.g.node("Add", [y1, y]) if kw.get("shortcut", True) else y
        y2 = self.conv(x, p["cv2"], dict(c2=c_, k=1))
        cat = self.g.node("Concat", [y1, y2], axis=1)
        return self.conv(cat, p["cv3"], dict(c2=c2, k=1))

    def proto(self, x: str, p: dict, kw: dict) -> str:
        y = self.conv(x, p["cv1"], dict(c2=kw.get("npr", 256), k=3))
        y = self.upsample(y, dict(scale_factor=2))
        y = self.conv(y, p["cv2"], dict(c2=kw.get("npr", 256), k=3))
        return self.conv(y, p["cv3"], dict(c2=kw.get("nm", 32), k=1))

    def detect_decode(self, xs: List[str], p: dict, kw: dict, sizes: List[tuple]) -> str:
        """Decoded predictions (1, sum of na*ny*nx, no), models/heads.py
        Detect's decode."""
        g = self.g
        anchors = np.asarray(kw["anchors"], np.float32)
        strides = kw["strides"]
        nc, nm = kw["nc"], kw.get("nm", 0)
        na = anchors.shape[1] // 2
        no = nc + 5 + nm
        outs = []
        for i, (x, (ny, nx)) in enumerate(zip(xs, sizes)):
            cp = p["m"][str(i)]
            w = g.tensor(_np(cp["weight"]))
            b = g.tensor(_np(cp["bias"]))
            raw = g.node("Conv", [x, w, b], strides=[1, 1], pads=[0, 0, 0, 0],
                         kernel_shape=[1, 1], group=1)
            # (1, na*no, ny, nx) -> (1, na, no, ny, nx) -> (1, na, ny, nx, no)
            r = g.node("Reshape", [raw, g.tensor(np.array([1, na, no, ny, nx], np.int64), "shape")])
            t = g.node("Transpose", [r], perm=[0, 1, 3, 4, 2])

            def sl(start, end):
                return g.node("Slice", [
                    t, g.tensor(np.array([start], np.int64), "st"),
                    g.tensor(np.array([end], np.int64), "en"),
                    g.tensor(np.array([4], np.int64), "ax")])

            xy, wh = sl(0, 2), sl(2, 4)
            conf = sl(4, 5 + nc)
            # grid and anchor constants (models/heads.py _level_grid)
            yy, xx = np.meshgrid(np.arange(ny, dtype=np.float32),
                                 np.arange(nx, dtype=np.float32), indexing="ij")
            grid = (np.stack([xx, yy], -1) - 0.5)[None, None]        # (1,1,ny,nx,2)
            grid = np.broadcast_to(grid, (1, na, ny, nx, 2)).copy()
            agrid = np.broadcast_to(anchors[i].reshape(1, na, 1, 1, 2),
                                    (1, na, ny, nx, 2)).copy()
            two = g.tensor(np.float32(2.0).reshape(()), "two")
            xy = g.node("Sigmoid", [xy])
            xy = g.node("Mul", [xy, two])
            xy = g.node("Add", [xy, g.tensor(grid, "grid")])
            xy = g.node("Mul", [xy, g.tensor(np.float32(strides[i]).reshape(()), "stride")])
            wh = g.node("Sigmoid", [wh])
            wh = g.node("Mul", [wh, two])
            wh = g.node("Pow", [wh, two])
            wh = g.node("Mul", [wh, g.tensor(agrid, "agrid")])
            conf = g.node("Sigmoid", [conf])
            parts = [xy, wh, conf]
            if nm:
                parts.append(sl(5 + nc, no))
            y = g.node("Concat", parts, axis=4)
            outs.append(g.node("Reshape", [y, g.tensor(
                np.array([1, na * ny * nx, no], np.int64), "shape")]))
        return g.node("Concat", outs, axis=1, out="pred")


SUPPORTED = {"Conv", "C3", "SPPF", "nn.Upsample", "Concat", "Detect", "Segment",
             "Bottleneck",
             # semantic zoo (nn/backbones.py dialect)
             "C3Conv", "ResNetStem", "ResNetLayer", "VGGBlock", "Upsample",
             "nn.Softmax", "SegmentHead"}


def _nest(sd: dict) -> dict:
    """A state_dict as nested dicts of float32 numpy arrays by its dotted
    names ("model.0.conv.weight" -> out["model"]["0"]["conv"]["weight"])."""
    out: dict = {}
    for k, v in sd.items():
        node = out
        *path, leaf = k.split(".")
        for s in path:
            node = node.setdefault(s, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def emit_graph(model: torch.nn.Module, imgsz: int, g, fuse: bool = True,
               supported=SUPPORTED, what: str = "ONNX export") -> Dict[str, tuple]:
    """Walk `model`'s ModelSpec, emitting its inference graph on `g` (an
    OnnxGraphBuilder, or io/tf_graph.py's TfGraph, which takes the same
    calls): NCHW input `images` (1, 3, imgsz, imgsz); returns {output name:
    NCHW shape}. With `fuse` the walk reads a conv+BN-folded copy of the
    model, else its convs keep their BatchNormalization nodes. Raises
    NotImplementedError naming the layers outside `supported` (its message
    begins with `what`)."""
    spec = model.spec
    unsup = {l.name for l in spec.layers} - set(supported)
    if unsup:
        raise NotImplementedError(
            f"{what} supports the core detect/segment zoo "
            f"({sorted(supported)}); config uses {sorted(unsup)}")
    src = copy.deepcopy(model).eval()
    params = _nest((src.fuse() if fuse else src).state_dict())["model"]
    ex = _Exporter(g, params)

    sizes = {}   # layer idx -> (ny, nx) for head grid constants
    chans = {}   # layer idx -> channels (for the Bottleneck shortcut check)
    cur_hw, cur_c = (imgsz, imgsz), 3
    y_names: List[Optional[str]] = []
    x = "images"
    outputs = {}
    for layer in spec.layers:
        f = layer.f

        def _abs(j):
            # other negative indices (e.g. -2) count back from this layer, as
            # the graph walker's y[j] does
            return j if j >= 0 else layer.i + j
        if isinstance(f, tuple):
            inp = [x if j == -1 else y_names[_abs(j)] for j in f]
            inp_hw = [cur_hw if j == -1 else sizes[_abs(j)] for j in f]
            inp_c = [cur_c if j == -1 else chans[_abs(j)] for j in f]
        else:
            inp = x if f == -1 else y_names[_abs(f)]
            inp_hw = cur_hw if f == -1 else sizes[_abs(f)]
            inp_c = cur_c if f == -1 else chans[_abs(f)]
        p = params.get(str(layer.i), {})
        kw = layer.kw()
        if layer.name == "Conv":
            s = kw.get("s", 1)
            x = ex.conv(inp, p, kw)
            cur_hw = (inp_hw[0] // s, inp_hw[1] // s)
            cur_c = kw["c2"]
        elif layer.name == "C3":
            x = ex.c3(inp, p, kw, inp_c)
            cur_hw, cur_c = inp_hw, kw["c2"]
        elif layer.name == "C3_DCNV3":
            # the row's repeat is an nn.Sequential of whole modules (compiler.py)
            x = inp
            for r in range(layer.n):
                x = ex.c3_dcnv3(x, p[str(r)] if layer.n > 1 else p, kw)
            cur_hw, cur_c = inp_hw, kw["c2"]
        elif layer.name == "Bottleneck":
            x = ex.bottleneck(inp, p, kw, inp_c)
            cur_hw, cur_c = inp_hw, kw["c2"]
        elif layer.name == "SPPF":
            x = ex.sppf(inp, p, kw, inp_c)
            cur_hw, cur_c = inp_hw, kw["c2"]
        elif layer.name in ("nn.Upsample", "Upsample"):
            x = ex.upsample(inp, kw)
            sf = int(kw.get("scale_factor") or 2)
            cur_hw = (inp_hw[0] * sf, inp_hw[1] * sf)
            cur_c = inp_c
        elif layer.name == "Concat":
            if kw.get("align"):
                # the semantic aligning Concat: every input resized bilinearly
                # to the FIRST input's size (nn/common.py Concat)
                inp = [t if hw == inp_hw[0] else ex.resize_to_c(t, hw, inp_hw[0])
                       for t, hw in zip(inp, inp_hw)]
                inp_hw = [inp_hw[0]] * len(inp)
            x = g.node("Concat", inp, axis=1)
            cur_hw, cur_c = inp_hw[0], sum(inp_c)
        elif layer.name == "C3Conv":
            x = ex.c3conv(inp, p, kw)
            cur_hw, cur_c = inp_hw, kw["c2"]
        elif layer.name == "ResNetStem":
            x = ex.resnet_stem(inp, p, kw)
            cur_hw = (inp_hw[0] // 4, inp_hw[1] // 4)
            cur_c = kw["c2"]
        elif layer.name == "ResNetLayer":
            x = ex.resnet_layer(inp, p, kw)
            s = kw.get("stride", 1)
            cur_hw = (inp_hw[0] // s, inp_hw[1] // s)
            cur_c = kw["c2"]
        elif layer.name == "VGGBlock":
            x = ex.vgg_block(inp, p, kw)
            s = 2 if kw.get("pool", True) else 1
            cur_hw = (inp_hw[0] // s, inp_hw[1] // s)
            cur_c = kw["c2"]
        elif layer.name == "nn.Softmax":
            x = g.node("Softmax", [inp], axis=int(kw.get("dim", 1)))
            cur_hw, cur_c = inp_hw, inp_c
        elif layer.name == "SegmentHead":
            x = ex.segment_head(inp, p, kw, inp_hw)
            cur_hw, cur_c = inp_hw[0], kw["nc"]
        elif layer.name in ("Detect", "Segment"):
            if layer.name == "Segment":
                pr = ex.proto(inp[0], p["proto"], kw)
                g.node("Identity", [pr], out="protos")
                outputs["protos"] = (1, kw.get("nm", 32),
                                     inp_hw[0][0] * 2, inp_hw[0][1] * 2)
            pred = ex.detect_decode(inp, p, kw, inp_hw)
            na = len(kw["anchors"][0]) // 2
            total = sum(na * h * w for (h, w) in inp_hw)
            outputs["pred"] = (1, total, kw["nc"] + 5 + kw.get("nm", 0))
            x = pred
        else:  # guarded by SUPPORTED
            raise NotImplementedError(layer.name)
        y_names.append(x)
        sizes[layer.i] = cur_hw
        chans[layer.i] = cur_c

    if not outputs:
        # a semantic graph (no Detect / Segment head): per-pixel class scores,
        # NCHW, at the INPUT size as SemanticSegModel.forward gives them (the
        # same half-pixel bilinear resize where the graph's output is coarser)
        if cur_hw != (imgsz, imgsz):
            x = ex.resize_to_c(x, cur_hw, (imgsz, imgsz))
            cur_hw = (imgsz, imgsz)
        x = g.node("Identity", [x], out="seg")
        outputs["seg"] = (1, cur_c, cur_hw[0], cur_hw[1])
    return outputs


def export_onnx(model: torch.nn.Module, imgsz: int, out_path) -> Path:
    """Export the FUSED inference graph of `model` (a GraphModel of the
    port, unfused; a conv+BN-folded copy is taken here) to ONNX: NCHW input
    `images` (1, 3, imgsz, imgsz) in [0, 1]; outputs `pred` (1, N, no) [+
    `protos` NCHW], or `seg` for a semantic graph. Raises NotImplementedError
    naming the layers outside SUPPORTED."""
    g = OnnxGraphBuilder()
    outputs = emit_graph(model, imgsz, g)
    out_path = Path(out_path)
    out_path.write_bytes(g.serialize({"images": (1, 3, imgsz, imgsz)}, outputs))
    return out_path
