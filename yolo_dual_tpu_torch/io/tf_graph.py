"""The port's inference graph as plain NHWC tensor ops, the form that the
SavedModel writer (io/savedmodel.py) and the TFLite writer (io/tflite.py)
serialise, with no TensorFlow installed.

    g = build_tf_graph(model, imgsz=640, fuse=True)   # a TfGraph
    pred, protos = run_tf_graph(g, x_nhwc)            # the same ops in torch

The walk is io/onnx_export.py's `emit_graph`: TfGraph takes its calls (an
NCHW graph of ONNX operators) and lowers each at once to NHWC ops, as TF's
Conv2D and TFLite's CONV_2D take them:

- a rank-4 value is held NHWC; a rank-4 constant operand, a Concat's or a
  Slice's axis follow it; a Reshape of a rank-4 value transposes it to NCHW
  first (and its rank-4 result back), so the Detect / Segment decode, which
  reshapes the raw head to (1, na, no, ny, nx), keeps ONNX's arithmetic;
- Conv weights are HWIO ((kh, kw, C, 1) for a depthwise conv); a padding
  that TF's SAME gives is SAME, none is VALID, any other (the 6x6 s2 p2 stem,
  a 3x3 s2 p1 conv on an even map) an explicit `pad` and VALID;
- the nearest 2x upsample (asymmetric, floor) is resize_nearest without
  half-pixel centres;
- DCNv3 (nn/dcn.py; the mask softmax and the sampling of
  kernels/dcn_sampling.py:dcnv3_core) becomes gathers: the sampling
  coordinates from the offsets and constant grids, floor, four corners
  clamped into the zero-padded input, each corner's flat index (the group's
  block of rows first) gathered from the input laid out as (g·Hin·Win, gc),
  weighted by its bilinear weight, its in-bounds flag and the mask, summed.

Ops (Node.op) and their TF / TFLite counterparts: conv (Conv2D or
DepthwiseConv2dNative + BiasAdd; CONV_2D / DEPTHWISE_CONV_2D), bn
(FusedBatchNormV3), sigmoid, softmax (last axis), floor, mul, add, sub, pow,
minimum, maximum, equal, cast (to float32 or int32), concat, maxpool (SAME),
pad (zeros), resize_nearest, reshape, transpose, slice, gather (axis 0), sum
(one axis): what the Segment zoo's SiLU graphs and DCNv3 need; an ONNX
operator outside them (a semantic graph's) raises NotImplementedError. The graph's input is `x`, NHWC
float32 (1, imgsz, imgsz, 3) in [0, 1]; its outputs `pred` (1, N, no) and,
for a Segment head, `protos` NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from yolo_dual_tpu_torch.io.onnx_export import SUPPORTED, emit_graph

TF_SUPPORTED = SUPPORTED | {"C3_DCNV3"}
_NCHW_TO_NHWC_AXIS = (0, 3, 1, 2)


@dataclass
class Node:
    op: str
    inputs: List[str]
    out: str
    attrs: dict = field(default_factory=dict)


def _same_pads(size: int, k: int, s: int):
    """TF's SAME padding (before, after) of one axis."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class TfGraph:
    """An NHWC graph: `nodes` in execution order, `consts` (name -> numpy
    array), `shapes` and `dtypes` ("float32" / "int32" / "bool") of every
    value, `outputs` (name -> value). Built by the ONNX builder's calls
    (`tensor`, `node`, `fresh`), which `emit_graph` makes."""

    def __init__(self, imgsz: int):
        self.imgsz = imgsz
        self.nodes: List[Node] = []
        self.consts: Dict[str, np.ndarray] = {}
        self.shapes: Dict[str, tuple] = {"x": (1, imgsz, imgsz, 3)}
        self.dtypes: Dict[str, str] = {"x": "float32"}
        self.outputs: Dict[str, str] = {}
        self._onnx_consts: Dict[str, np.ndarray] = {}
        self._alias: Dict[str, str] = {"images": "x"}
        self._n = 0

    # -- the ONNX builder's interface --------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def tensor(self, arr: np.ndarray, hint: str = "w") -> str:
        name = self.fresh(hint)
        self._onnx_consts[name] = np.asarray(arr)
        return name

    def node(self, op: str, inputs, out: Optional[str] = None, **attrs) -> str:
        out = out or self.fresh(op.lower())
        lower = getattr(self, f"_onnx_{op}", None)
        if lower is None:
            raise NotImplementedError(f"TF export: ONNX operator {op}")
        self._alias[out] = lower(list(inputs), **attrs)
        if out in ("pred", "protos", "seg"):
            self.outputs[out] = self._alias[out]
        return out

    # -- NHWC graph construction ---------------------------------------------
    def const(self, arr, dtype=None) -> str:
        arr = np.asarray(arr, dtype=dtype)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        name = self.fresh("c")
        self.consts[name] = np.ascontiguousarray(arr)
        self.shapes[name] = arr.shape
        self.dtypes[name] = str(arr.dtype)
        return name

    def emit(self, op: str, inputs: List[str], shape, dtype: str = "float32", **attrs) -> str:
        out = self.fresh(op)
        self.nodes.append(Node(op, list(inputs), out, attrs))
        self.shapes[out] = tuple(int(d) for d in shape)
        self.dtypes[out] = dtype
        return out

    def _val(self, name: str) -> str:
        """The NHWC value of an ONNX name (an initializer becomes a constant,
        a rank-4 one transposed to NHWC)."""
        if name in self._alias:
            return self._alias[name]
        arr = self._onnx_consts[name]
        self._alias[name] = self.const(arr.transpose(0, 2, 3, 1) if arr.ndim == 4 else arr)
        return self._alias[name]

    def _ew(self, op: str, a: str, b: str) -> str:
        shape = np.broadcast_shapes(self.shapes[a], self.shapes[b])
        return self.emit(op, [a, b], shape)

    def _pool_padding(self, x: str, k, s, d, pads):
        """(input, "SAME" | "VALID") for a conv or pool with ONNX `pads`,
        padding `x` explicitly with zeros where SAME does not give them."""
        _, h, w, c = self.shapes[x]
        keff = [d * (kk - 1) + 1 for kk in k]
        pt, pl, pb, pr = pads
        if (_same_pads(h, keff[0], s[0]), _same_pads(w, keff[1], s[1])) == ((pt, pb), (pl, pr)):
            return x, "SAME"
        if any(pads):
            x = self.emit("pad", [x, self.const([[0, 0], [pt, pb], [pl, pr], [0, 0]], np.int32)],
                          (1, h + pt + pb, w + pl + pr, c))
        return x, "VALID"

    def conv(self, x: str, w_oihw: np.ndarray, b: Optional[np.ndarray], strides, dilation: int,
             pads, group: int) -> str:
        _, h, w, c = self.shapes[x]
        o, i, kh, kw = w_oihw.shape
        depthwise = group > 1
        if depthwise and not (group == c == o and i == 1):
            raise NotImplementedError(f"TF export: grouped conv of {group} groups over {c} "
                                      "channels (only depthwise)")
        x, padding = self._pool_padding(x, (kh, kw), strides, dilation, pads)
        weight = self.const(w_oihw.transpose(2, 3, 0, 1) if depthwise else
                            w_oihw.transpose(2, 3, 1, 0))
        _, hp, wp, _ = self.shapes[x]
        keff = (dilation * (kh - 1) + 1, dilation * (kw - 1) + 1)
        if padding == "SAME":
            ho, wo = -(-hp // strides[0]), -(-wp // strides[1])
        else:
            ho, wo = (hp - keff[0]) // strides[0] + 1, (wp - keff[1]) // strides[1] + 1
        inputs = [x, weight] + ([self.const(b)] if b is not None else [])
        return self.emit("conv", inputs, (1, ho, wo, o), strides=tuple(strides),
                         dilation=dilation, padding=padding, depthwise=depthwise)

    # -- ONNX operators ------------------------------------------------------
    def _onnx_Conv(self, inputs, strides, pads, kernel_shape, group=1, dilations=(1, 1)):
        b = self._onnx_consts[inputs[2]] if len(inputs) > 2 else None
        return self.conv(self._val(inputs[0]), self._onnx_consts[inputs[1]], b, strides,
                         dilations[0], pads, group)

    def _onnx_BatchNormalization(self, inputs, epsilon):
        x = self._val(inputs[0])
        return self.emit("bn", [x] + [self._val(n) for n in inputs[1:]], self.shapes[x],
                         epsilon=float(epsilon))

    def _onnx_Sigmoid(self, inputs):
        return self.emit("sigmoid", [self._val(inputs[0])], self.shapes[self._val(inputs[0])])

    def _onnx_Mul(self, inputs):
        return self._ew("mul", *map(self._val, inputs))

    def _onnx_Add(self, inputs):
        return self._ew("add", *map(self._val, inputs))

    def _onnx_Pow(self, inputs):
        return self._ew("pow", *map(self._val, inputs))

    def _onnx_Identity(self, inputs):
        return self._val(inputs[0])

    def _onnx_Concat(self, inputs, axis):
        xs = [self._val(n) for n in inputs]
        rank = len(self.shapes[xs[0]])
        axis = _NCHW_TO_NHWC_AXIS[axis] if rank == 4 else axis % rank
        shape = list(self.shapes[xs[0]])
        shape[axis] = sum(self.shapes[t][axis] for t in xs)
        return self.emit("concat", xs, shape, axis=axis)

    def _onnx_MaxPool(self, inputs, kernel_shape, strides, pads):
        x, padding = self._pool_padding(self._val(inputs[0]), kernel_shape, strides, 1, pads)
        if padding != "SAME":   # SPPF's pools are; a ResNet stem's is semantic, not exported
            raise NotImplementedError(f"TF export: MaxPool {kernel_shape} s{strides} p{pads}")
        _, h, w, c = self.shapes[x]
        return self.emit("maxpool", [x], (1, -(-h // strides[0]), -(-w // strides[1]), c),
                         k=tuple(kernel_shape), strides=tuple(strides))

    def _onnx_Resize(self, inputs, mode, coordinate_transformation_mode, nearest_mode=None):
        x = self._val(inputs[0])
        scales = self._onnx_consts[inputs[2]]
        _, h, w, c = self.shapes[x]
        size = (int(np.floor(h * scales[2])), int(np.floor(w * scales[3])))
        shape = (1, size[0], size[1], c)
        if (mode, coordinate_transformation_mode, nearest_mode) != ("nearest", "asymmetric", "floor"):
            raise NotImplementedError(f"TF export: {mode} Resize ({coordinate_transformation_mode})")
        return self.emit("resize_nearest", [x, self.const(size, np.int32)], shape)

    def reshape(self, x: str, shape) -> str:
        return self.emit("reshape", [x, self.const(list(shape), np.int32)], shape,
                         self.dtypes[x])

    def transpose(self, x: str, perm) -> str:
        shape = tuple(self.shapes[x][p] for p in perm)
        return self.emit("transpose", [x, self.const(list(perm), np.int32)], shape,
                         self.dtypes[x])

    def _onnx_Reshape(self, inputs):
        x = self._val(inputs[0])
        shape = [int(d) for d in self._onnx_consts[inputs[1]]]
        if len(self.shapes[x]) == 4:
            x = self.transpose(x, (0, 3, 1, 2))
        if len(shape) == 4:
            return self.transpose(self.reshape(x, shape), (0, 2, 3, 1))
        return self.reshape(x, shape)

    def _onnx_Transpose(self, inputs, perm):
        x = self._val(inputs[0])
        if len(self.shapes[x]) == 4:
            raise NotImplementedError("TF export: Transpose of an NCHW map")
        return self.transpose(x, perm)

    def slice(self, x: str, begin, end) -> str:
        shape = [e - b for b, e in zip(begin, end)]
        return self.emit("slice", [x, self.const(list(begin), np.int32),
                                   self.const(list(end), np.int32)], shape)

    def _onnx_Slice(self, inputs):
        x = self._val(inputs[0])
        start, end, axis = (int(self._onnx_consts[n][0]) for n in inputs[1:4])
        shape = self.shapes[x]
        if len(shape) == 4:
            axis = _NCHW_TO_NHWC_AXIS[axis]
        begin, stop = [0] * len(shape), list(shape)
        begin[axis], stop[axis] = start, min(end, shape[axis])
        return self.slice(x, begin, stop)

    def _onnx_DCNv3(self, inputs, kernel, stride, pad, dilation, group, offset_scale):
        return self.dcnv3(*map(self._val, inputs), kernel, stride, pad, dilation, group,
                          offset_scale)

    def dcnv3(self, proj: str, offset: str, mask: str, kernel: int, stride: int, pad: int,
              dilation: int, group: int, offset_scale: float) -> str:
        """kernels/dcn_sampling.py:dcnv3_core after the mask's softmax, on
        NHWC values of batch 1: proj (1, H, W, C), offset (1, Ho, Wo,
        g·kk·2), mask logits (1, Ho, Wo, g·kk) -> (1, Ho, Wo, C)."""
        _, h, w, c = self.shapes[proj]
        _, ho, wo, _ = self.shapes[offset]
        kk, gc = kernel * kernel, c // group
        hin, win = h + 2 * pad, w + 2 * pad
        pts = (ho, wo, group, kk)
        m = self.emit("softmax", [self.reshape(mask, pts)], pts)
        offs = self.reshape(offset, pts + (2,))
        half = (dilation * (kernel - 1)) // 2
        vals = -half + np.arange(kernel, dtype=np.float32) * dilation
        gx = np.repeat(vals, kernel)           # kernel points X-major: p = ix·k + iy
        gy = np.tile(vals, kernel)
        base_y = np.arange(ho, dtype=np.float32) * stride + half + 0.5
        base_x = np.arange(wo, dtype=np.float32) * stride + half + 0.5
        cx = base_x[None, :, None, None] + offset_scale * gx[None, None, None, :] - 0.5
        cy = base_y[:, None, None, None] + offset_scale * gy[None, None, None, :] - 0.5
        coords = []
        for axis, grid in ((0, cx), (1, cy)):
            o = self.reshape(self.slice(offs, [0] * 4 + [axis], list(pts) + [axis + 1]), pts)
            if offset_scale != 1.0:
                o = self._ew("mul", o, self.const(np.float32(offset_scale)))
            coords.append(self._ew("add", o, self.const(np.broadcast_to(grid, pts)
                                                         .astype(np.float32))))
        sx, sy = coords
        x0, y0 = (self.emit("floor", [t], pts) for t in (sx, sy))
        wx, wy = self._ew("sub", sx, x0), self._ew("sub", sy, y0)
        one = self.const(np.float32(1.0))
        ux, uy = self._ew("sub", one, wx), self._ew("sub", one, wy)
        xp = self.emit("pad", [proj, self.const([[0, 0], [pad, pad], [pad, pad], [0, 0]],
                                                np.int32)], (1, hin, win, c))
        table = self.reshape(self.transpose(self.reshape(xp, (hin * win, group, gc)), (1, 0, 2)),
                             (group * hin * win, gc))
        group_rows = self.const(np.broadcast_to(
            (np.arange(group, dtype=np.float32) * hin * win)[None, None, :, None], pts))
        out = None
        for dy, dx, wgt in ((0, 0, self._ew("mul", ux, uy)), (0, 1, self._ew("mul", wx, uy)),
                            (1, 0, self._ew("mul", ux, wy)), (1, 1, self._ew("mul", wx, wy))):
            clamped = []
            for t, d, n in ((x0, dx, win), (y0, dy, hin)):
                t = self._ew("add", t, self.const(np.float32(d))) if d else t
                cl = self._ew("minimum", self._ew("maximum", t, self.const(np.float32(0))),
                              self.const(np.float32(n - 1)))
                inside = self.emit("cast", [self.emit("equal", [t, cl], pts, "bool")], pts,
                                   to="float32")
                wgt = self._ew("mul", wgt, inside)
                clamped.append(cl)
            flat = self._ew("add", self._ew("add", self._ew("mul", clamped[1],
                                                            self.const(np.float32(win))),
                                            clamped[0]), group_rows)
            idx = self.emit("cast", [flat], pts, "int32", to="int32")
            vals_ = self.emit("gather", [table, idx], pts + (gc,))
            term = self._ew("mul", vals_, self.reshape(self._ew("mul", wgt, m), pts + (1,)))
            out = term if out is None else self._ew("add", out, term)
        summed = self.emit("sum", [out, self.const(np.int32(3))], (ho, wo, group, gc), axis=3)
        return self.reshape(summed, (1, ho, wo, c))


def build_tf_graph(model: torch.nn.Module, imgsz: int, fuse: bool = True) -> TfGraph:
    """The NHWC graph of `model` (a Segment model of the port) at input
    (1, imgsz, imgsz, 3); `fuse` folds conv+BN first, else the graph keeps its
    BatchNorms. Raises NotImplementedError naming layers it cannot lower."""
    g = TfGraph(imgsz)
    emit_graph(model, imgsz, g, fuse=fuse, supported=TF_SUPPORTED, what="TF export")
    return g


# ---------------------------------------------------------------------------
# the same ops in torch: the tests' and the int8 calibration's forward
# ---------------------------------------------------------------------------

def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _same(x: torch.Tensor, k, s, padding: str, fill: float) -> torch.Tensor:
    """NCHW `x` padded as TF's SAME pads it (a pool's pad never wins a max)."""
    if padding != "SAME":
        return x
    (pt, pb), (pl, pr) = (_same_pads(x.shape[2], k[0], s[0]), _same_pads(x.shape[3], k[1], s[1]))
    return F.pad(x, (pl, pr, pt, pb), value=fill)


def _run_node(n: Node, a: List[torch.Tensor], consts: Dict[str, np.ndarray]):
    op = n.op
    if op == "conv":
        x, w = a[0], a[1]
        weight = w.permute(2, 3, 0, 1) if n.attrs["depthwise"] else w.permute(3, 2, 0, 1)
        d = n.attrs["dilation"]
        k = [d * (s - 1) + 1 for s in w.shape[:2]]
        y = F.conv2d(_same(_nchw(x), k, n.attrs["strides"], n.attrs["padding"], 0.0),
                     weight.contiguous(), a[2] if len(a) > 2 else None, n.attrs["strides"], 0,
                     d, x.shape[3] if n.attrs["depthwise"] else 1)
        return _nhwc(y)
    if op == "bn":
        x, scale, offset, mean, var = a
        return (x - mean) * (scale / torch.sqrt(var + n.attrs["epsilon"])) + offset
    if op in ("sigmoid", "floor"):
        return getattr(torch, op)(a[0])
    if op == "softmax":
        return torch.softmax(a[0], -1)
    if op in ("mul", "add", "sub", "pow", "minimum", "maximum"):
        return getattr(torch, op)(a[0], a[1])
    if op == "equal":
        return torch.eq(a[0], a[1])
    if op == "cast":
        return a[0].to(getattr(torch, n.attrs["to"]))
    if op == "concat":
        return torch.cat(a, n.attrs["axis"])
    if op == "maxpool":
        k, st = n.attrs["k"], n.attrs["strides"]
        return _nhwc(F.max_pool2d(_same(_nchw(a[0]), k, st, "SAME", float("-inf")), k, st))
    if op == "pad":
        p = consts[n.inputs[1]]
        return F.pad(a[0], tuple(int(v) for v in p[::-1].reshape(-1)))
    if op == "resize_nearest":
        size = tuple(int(v) for v in consts[n.inputs[1]])
        return _nhwc(F.interpolate(_nchw(a[0]), size=size, mode="nearest"))
    if op == "reshape":
        return a[0].reshape(tuple(int(v) for v in consts[n.inputs[1]]))
    if op == "transpose":
        return a[0].permute(*(int(v) for v in consts[n.inputs[1]]))
    if op == "slice":
        b, e = consts[n.inputs[1]], consts[n.inputs[2]]
        return a[0][tuple(slice(int(i), int(j)) for i, j in zip(b, e))]
    if op == "gather":
        return a[0][a[1].long()]
    if op == "sum":
        return a[0].sum(n.attrs["axis"])
    raise NotImplementedError(op)


def run_tf_graph(g: TfGraph, x: torch.Tensor, observe=None) -> Dict[str, torch.Tensor]:
    """Run `g` on NHWC `x` (1, imgsz, imgsz, 3) with torch on x's device:
    {output name: tensor}. `observe(name, tensor)`, where given, sees every
    value the graph computes (the int8 calibration's per-tensor ranges)."""
    dev = x.device
    vals: Dict[str, torch.Tensor] = {"x": x.float()}
    for name, arr in g.consts.items():
        vals[name] = torch.from_numpy(np.array(arr)).to(dev)
    if observe is not None:
        observe("x", vals["x"])
    for n in g.nodes:
        vals[n.out] = _run_node(n, [vals[i] for i in n.inputs], g.consts)
        if observe is not None:
            observe(n.out, vals[n.out])
    return {k: vals[v] for k, v in g.outputs.items()}
