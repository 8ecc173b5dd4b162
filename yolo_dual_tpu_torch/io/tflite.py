"""TFLite writer with no TensorFlow or flatbuffers package installed (port
of the JAX package's root export.py:92 export_tflite, which converts its
SavedModel with TF's converter), float32 and post-training full-integer
int8.

    g = build_tf_graph(model, 640, fuse=True)
    write_tflite(g, "m.tflite")                                   # float32
    write_tflite(g, "m_int8.tflite", ranges=calibrate(g, frames, "cuda"))

The file is a TFLite flatbuffer of schema version 3 (identifier `TFL3`),
built back to front by `_Flatbuffer` (vtables, 4-byte offsets forward, the
weights' buffers aligned to 16), with builtin operators only: each op of
io/tf_graph.py maps to one (conv -> CONV_2D or DEPTHWISE_CONV_2D with OHWI /
1HWC weights and its bias, sigmoid -> LOGISTIC, concat -> CONCATENATION,
maxpool -> MAX_POOL_2D, pad -> PAD, resize_nearest ->
RESIZE_NEAREST_NEIGHBOR, slice -> STRIDED_SLICE, gather -> GATHER, sum -> SUM,
...). An operator code carries its number both in `deprecated_builtin_code`
(a byte) and `builtin_code`, as TF 2.21's reader takes them. The input `x`
is NHWC float32 (1, imgsz, imgsz, 3); the outputs are `pred` (rank 3) and
`protos` (rank 4, NHWC), which MultiBackend tells apart by rank.

int8 follows the settings of JAX's converter (export.py:99-123: optimise
for size, a representative dataset, builtin ops with float fallback, float
input and output):

- every conv runs in int8 (QUANTIZE before it where its input is float),
  weights symmetric per output channel, biases int32 at the input's scale
  times the channel's;
- logistic, mul, add, concat, maxpool, pad, resize_nearest, reshape and
  transpose run in int8 where their inputs come
  in int8, else in float; every other op (the DCNv3 sampling's floor, gather
  and sum, the mask softmax, the Detect decode from its first slice on) runs
  in float after a DEQUANTIZE, and so do the outputs;
- activation ranges are the per-tensor min and max (widened to hold 0) of
  each value over the representative frames, from `calibrate`, which runs
  the graph's ops in torch (io/tf_graph.py:run_tf_graph) on the device;
- TFLite's int8 kernels' constraints: LOGISTIC's output has scale 1/256 and
  zero point -128; maxpool, pad, resize, reshape and transpose keep their
  input's parameters; a CONCATENATION input whose parameters differ from the
  output's is requantised (QUANTIZE int8 -> int8) first.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from yolo_dual_tpu_torch.io.tf_graph import TfGraph, run_tf_graph

# schema.fbs enums
OPS = {"ADD": 0, "CONCATENATION": 2, "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4, "DEQUANTIZE": 6,
       "FLOOR": 8, "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18, "RESHAPE": 22, "SOFTMAX": 25,
       "PAD": 34, "GATHER": 36, "TRANSPOSE": 39, "SUB": 41, "STRIDED_SLICE": 45, "CAST": 53,
       "MAXIMUM": 55, "MINIMUM": 57, "EQUAL": 71, "SUM": 74, "POW": 78,
       "RESIZE_NEAREST_NEIGHBOR": 97, "QUANTIZE": 114}
TTYPE = {"float32": 0, "int32": 2, "bool": 6, "int8": 9}
SAME, VALID = 0, 1
# the BuiltinOptions union's member of each op that takes options (Conv2DOptions,
# DepthwiseConv2DOptions, Pool2DOptions, SoftmaxOptions, ConcatenationOptions, AddOptions,
# ReshapeOptions, MulOptions, GatherOptions, ReducerOptions, SubOptions,
# ResizeNearestNeighborOptions, CastOptions)
OPTIONS = {"CONV_2D": 1, "DEPTHWISE_CONV_2D": 2, "MAX_POOL_2D": 5, "SOFTMAX": 9,
           "CONCATENATION": 10, "ADD": 11, "RESHAPE": 17, "MUL": 21, "GATHER": 23, "SUM": 27,
           "SUB": 28, "RESIZE_NEAREST_NEIGHBOR": 74, "CAST": 37}
_INT8_FOLLOW = {"sigmoid", "mul", "add", "concat", "maxpool", "pad", "resize_nearest",
                "reshape", "transpose"}
_KEEP_PARAMS = {"maxpool", "pad", "resize_nearest", "reshape", "transpose"}


class _Flatbuffer:
    """A flatbuffer built back to front: chunks are prepended (kept in a list
    and joined reversed), an object's position is its distance from the end,
    and a 4-byte offset is written after the object it points to."""

    _FMT = {"u8": "<B", "i8": "<b", "bool": "<B", "i32": "<i", "u32": "<I", "f32": "<f",
            "i64": "<q"}

    def __init__(self):
        self.chunks: List[bytes] = []
        self.size = 0
        self.minalign = 4

    def _put(self, b):
        self.chunks.append(b)
        self.size += len(b)

    def prep(self, align: int, extra: int = 0):
        self.minalign = max(self.minalign, align)
        pad = (-(self.size + extra)) % align
        if pad:
            self._put(b"\0" * pad)

    def _uoffset(self, target: int):
        self.prep(4)
        self._put(struct.pack("<I", self.size + 4 - target))

    def vector(self, arr: np.ndarray, align: int = 4) -> int:
        data = np.ascontiguousarray(arr).tobytes()
        self.prep(max(align, 4), len(data))
        self._put(data)
        self._put(struct.pack("<I", len(arr)))
        return self.size

    def offsets(self, targets: List[int]) -> int:
        self.prep(4, 4 * len(targets))
        for t in reversed(targets):
            self._put(struct.pack("<I", self.size + 4 - t))
        self._put(struct.pack("<I", len(targets)))
        return self.size

    def string(self, s: str) -> int:
        data = s.encode() + b"\0"
        self.prep(4, len(data))
        self._put(data)
        self._put(struct.pack("<I", len(data) - 1))
        return self.size

    def table(self, fields: List[Tuple[int, str, object]]) -> int:
        """A table of (slot, kind, value); kind "off" is a position written
        earlier, else a scalar kind of _FMT."""
        start, where = self.size, {}
        for slot, kind, value in fields:
            if kind == "off":
                self._uoffset(value)
            else:
                fmt = self._FMT[kind]
                self.prep(struct.calcsize(fmt))
                self._put(struct.pack(fmt, value))
            where[slot] = self.size
        self.prep(4)
        soffset = bytearray(4)
        self._put(soffset)
        table = self.size
        n = max(where) + 1 if where else 0
        vt = [4 + 2 * n, table - start] + [table - where[s] if s in where else 0 for s in range(n)]
        self._put(struct.pack(f"<{len(vt)}H", *vt))
        soffset[:] = struct.pack("<i", self.size - table)
        return table

    def finish(self, root: int, ident: bytes) -> bytes:
        self.prep(self.minalign, 8)
        self._put(ident)
        self._uoffset(root)
        return b"".join(reversed(self.chunks))


def qparams(lo: float, hi: float, min_scale: float = 1e-8) -> Tuple[float, int]:
    """Asymmetric int8 (scale, zero point) of the range [lo, hi] widened to
    hold 0, the scale at least `min_scale` (the range widened about its
    middle)."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = (hi - lo) / 255.0
    if scale < min_scale:
        mid, scale = (lo + hi) / 2, min_scale
        lo = min(mid - 127.5 * scale, 0.0)
    return scale, int(np.clip(np.round(-128 - lo / scale), -128, 127))


class _Writer:
    """TfGraph -> the lists of a TFLite subgraph: tensors, buffers, ops."""

    def __init__(self, g: TfGraph, ranges: Optional[Dict[str, Tuple[float, float]]]):
        self.g, self.ranges = g, ranges
        self.tensors: List[dict] = []
        self.buffers: List[bytes] = [b""]
        self.ops: List[tuple] = []
        self.f: Dict[str, int] = {}     # value -> its float32 (or int32 / bool) tensor
        self.q: Dict[str, int] = {}     # value -> its int8 tensor
        self.qp: Dict[str, Tuple[float, int]] = {}

    def tensor(self, name: str, shape, ttype: str, data: Optional[np.ndarray] = None,
               quant: Optional[dict] = None) -> int:
        buf = 0
        if data is not None:
            self.buffers.append(np.ascontiguousarray(data).tobytes())
            buf = len(self.buffers) - 1
        self.tensors.append(dict(name=name, shape=list(shape), type=TTYPE[ttype], buffer=buf,
                                 quant=quant))
        return len(self.tensors) - 1

    def const(self, arr, name: str = "const") -> int:
        arr = np.asarray(arr)
        arr = arr.astype(np.int32) if arr.dtype.kind in "iu" else arr.astype(np.float32)
        return self.tensor(name, arr.shape, str(arr.dtype), arr)

    def op(self, code: str, inputs: List[int], outputs: List[int], options=()):
        self.ops.append((code, inputs, outputs, list(options)))

    # -- domains -------------------------------------------------------------
    def float_of(self, v: str) -> int:
        if v in self.f:
            return self.f[v]
        if v in self.g.consts:
            self.f[v] = self.const(self.g.consts[v], v)
            return self.f[v]
        out = self.tensor(v + "/dequant", self.g.shapes[v], "float32")
        self.op("DEQUANTIZE", [self.q[v]], [out])
        self.f[v] = out
        return out

    def _qtensor(self, name: str, shape, params: Tuple[float, int]) -> int:
        return self.tensor(name, shape, "int8", quant=dict(scale=[params[0]], zero_point=[params[1]]))

    def int8_of(self, v: str, params: Optional[Tuple[float, int]] = None) -> int:
        """v's int8 tensor, at `params` where given (requantised if it holds
        others), else at its own."""
        if v in self.q and (params is None or self.qp[v] == params):
            return self.q[v]
        params = params or self.qp.get(v) or qparams(*self.ranges[v])
        src = self.q[v] if v in self.q else self.float_of(v)
        out = self._qtensor(v + "/quant", self.g.shapes[v], params)
        self.op("QUANTIZE", [src], [out])
        if v not in self.q:
            self.q[v], self.qp[v] = out, params
        return out

    def out_tensor(self, v: str, int8: bool, params=None) -> int:
        shape = self.g.shapes[v]
        if int8:
            params = params or qparams(*self.ranges[v])
            self.q[v], self.qp[v] = self._qtensor(v, shape, params), params
            return self.q[v]
        self.f[v] = self.tensor(v, shape, self.g.dtypes[v])
        return self.f[v]

    # -- ops -----------------------------------------------------------------
    def conv(self, n, int8: bool):
        x, w, b = n.inputs[0], self.g.consts[n.inputs[1]], (
            self.g.consts[n.inputs[2]] if len(n.inputs) > 2 else None)
        a = n.attrs
        w = w.transpose(3, 0, 1, 2)                 # HWIO -> OHWI, (kh, kw, C, 1) -> (1, kh, kw, C)
        cout = w.shape[3] if a["depthwise"] else w.shape[0]
        b = np.zeros(cout, np.float32) if b is None else b
        if int8:
            qdim = 3 if a["depthwise"] else 0
            xin = self.int8_of(x)
            amax = np.abs(w).max(axis=tuple(d for d in range(4) if d != qdim))
            # a weight scale at least |b| / (input scale · (2^31 - 1)), so that the
            # int32 bias holds the bias (as TF's quantizer widens it)
            ws = np.maximum(amax / 127.0, np.abs(b) / (self.qp[x][0] * (2 ** 31 - 1)))
            ws = np.where(ws > 0, ws, 1.0).astype(np.float32)
            wq = np.clip(np.round(w / ws.reshape([-1 if d == qdim else 1 for d in range(4)])),
                         -127, 127).astype(np.int8)
            bs = (ws * self.qp[x][0]).astype(np.float32)
            wt = self.tensor(n.out + "/w", wq.shape, "int8", wq, dict(
                scale=ws.tolist(), zero_point=[0] * cout, quantized_dimension=qdim))
            bt = self.tensor(n.out + "/b", b.shape, "int32",
                             np.clip(np.round(b / bs), -2 ** 31 + 1, 2 ** 31 - 1).astype(np.int32),
                             dict(scale=bs.tolist(), zero_point=[0] * cout, quantized_dimension=0))
        else:
            xin = self.float_of(x)
            wt = self.const(w, n.out + "/w")
            bt = self.const(b, n.out + "/b")
        # int8 kernels (XNNPACK's among them) take an output scale above
        # input scale · weight scale / 256: a range of ~0 (DCNv3's zero-initialised
        # offset heads) is widened to it
        out = self.out_tensor(n.out, int8, int8 and qparams(
            *self.ranges[n.out], min_scale=float(self.qp[x][0] * ws.max() / 128)))
        s, d = a["strides"], a["dilation"]
        pad = SAME if a["padding"] == "SAME" else VALID
        if a["depthwise"]:
            self.op("DEPTHWISE_CONV_2D", [xin, wt, bt], [out],
                    [(0, "i8", pad), (1, "i32", s[1]), (2, "i32", s[0]), (3, "i32", 1),
                     (5, "i32", d), (6, "i32", d)])
        else:
            self.op("CONV_2D", [xin, wt, bt], [out],
                    [(0, "i8", pad), (1, "i32", s[1]), (2, "i32", s[0]), (4, "i32", d),
                     (5, "i32", d)])

    def node(self, n, int8: bool):
        g, a, op = self.g, n.attrs, n.op
        if op == "conv":
            return self.conv(n, int8)
        values = [i for i in n.inputs if i not in g.consts]
        runs_int8 = (int8 and op in _INT8_FOLLOW and all(v in self.q for v in values)
                     and (op not in ("mul", "add") or len(values) == 2))
        if op == "concat" and runs_int8:
            params = qparams(*self.ranges[n.out])
            ins = [self.int8_of(v, params) for v in n.inputs]
            out = self.out_tensor(n.out, True, params)
            return self.op("CONCATENATION", ins, [out], [(0, "i32", a["axis"])])
        if runs_int8:
            def get(v):
                return self.int8_of(v)
        else:
            get = self.float_of
        ins = [get(v) if v not in g.consts or op in ("mul", "add", "sub", "pow", "minimum",
                                                       "maximum", "equal")
               else self.const(g.consts[v], v) for v in n.inputs]
        params = None
        if runs_int8 and op in _KEEP_PARAMS:
            params = self.qp[values[0]]
        elif runs_int8 and op == "sigmoid":
            params = (1.0 / 256.0, -128)
        out = self.out_tensor(n.out, runs_int8, params)
        if op == "sigmoid":
            return self.op("LOGISTIC", ins, [out])
        if op == "floor":
            return self.op("FLOOR", ins, [out])
        if op == "softmax":
            return self.op("SOFTMAX", ins, [out], [(0, "f32", 1.0)])
        if op in ("mul", "add", "sub"):
            return self.op(op.upper(), ins, [out], [(0, "i8", 0)])
        if op in ("pow", "minimum", "maximum", "equal"):
            return self.op(op.upper(), ins, [out])
        if op == "cast":
            return self.op("CAST", ins, [out], [(0, "i8", TTYPE[g.dtypes[n.inputs[0]]]),
                                                (1, "i8", TTYPE[a["to"]])])
        if op == "concat":
            return self.op("CONCATENATION", ins, [out], [(0, "i32", a["axis"])])
        if op == "maxpool":
            k, s = a["k"], a["strides"]
            return self.op("MAX_POOL_2D", ins, [out], [
                (0, "i8", SAME), (1, "i32", s[1]), (2, "i32", s[0]), (3, "i32", k[1]),
                (4, "i32", k[0])])
        if op == "pad":   # zeros: an int8 input pads with its zero point, the real 0
            return self.op("PAD", ins, [out])
        if op == "resize_nearest":
            return self.op("RESIZE_NEAREST_NEIGHBOR", ins, [out], [(0, "bool", 0), (1, "bool", 0)])
        if op == "reshape":
            return self.op("RESHAPE", ins, [out], [(0, "vec_i32", g.consts[n.inputs[1]])])
        if op == "transpose":
            return self.op("TRANSPOSE", ins, [out])
        if op == "slice":
            strides = self.const(np.ones(len(g.shapes[n.inputs[0]]), np.int32), n.out + "/strides")
            return self.op("STRIDED_SLICE", ins + [strides], [out])
        if op == "gather":
            return self.op("GATHER", ins, [out], [(0, "i32", 0), (1, "i32", 0)])
        if op == "sum":
            return self.op("SUM", ins, [out], [(0, "bool", 0)])
        raise NotImplementedError(f"TFLite: op {op} (a TFLite file is written from a "
                                  "conv+BN-folded graph)")

    def build(self, int8: bool) -> bytes:
        g = self.g
        self.f["x"] = self.tensor("x", g.shapes["x"], "float32")
        for n in g.nodes:
            self.node(n, int8)
        outs = []
        for name in sorted(g.outputs):      # pred, protos
            t = self.float_of(g.outputs[name])
            self.tensors[t]["name"] = name
            outs.append(t)
        return self.serialize([self.f["x"]], outs)

    def serialize(self, inputs: List[int], outputs: List[int]) -> bytes:
        fb = _Flatbuffer()
        buffers = [fb.table([(0, "off", fb.vector(np.frombuffer(b, np.uint8), 16))] if b else [])
                   for b in self.buffers]
        tensors = []
        for t in self.tensors:
            fields = [(0, "off", fb.vector(np.asarray(t["shape"], np.int32))),
                      (1, "i8", t["type"]), (2, "u32", t["buffer"]),
                      (3, "off", fb.string(t["name"]))]
            q = t["quant"]
            if q:
                qf = [(2, "off", fb.vector(np.asarray(q["scale"], np.float32))),
                      (3, "off", fb.vector(np.asarray(q["zero_point"], np.int64), 8))]
                if q.get("quantized_dimension"):
                    qf.append((6, "i32", q["quantized_dimension"]))
                fields.append((4, "off", fb.table(qf)))
            tensors.append(fb.table(fields))
        codes = sorted({code for code, *_ in self.ops}, key=lambda c: OPS[c])
        ops = []
        for code, ins, outs, options in self.ops:
            fields = [(0, "u32", codes.index(code)),
                      (1, "off", fb.vector(np.asarray(ins, np.int32))),
                      (2, "off", fb.vector(np.asarray(outs, np.int32)))]
            if code in OPTIONS:
                opts = [(s, "off", fb.vector(np.asarray(v, np.int32))) if k == "vec_i32"
                        else (s, k, v) for s, k, v in options]
                fields += [(3, "u8", OPTIONS[code]), (4, "off", fb.table(opts))]
            ops.append(fb.table(fields))
        subgraph = fb.table([
            (0, "off", fb.offsets(tensors)), (1, "off", fb.vector(np.asarray(inputs, np.int32))),
            (2, "off", fb.vector(np.asarray(outputs, np.int32))), (3, "off", fb.offsets(ops)),
            (4, "off", fb.string("main"))])
        opcodes = [fb.table([(0, "i8", min(OPS[c], 127)), (2, "i32", 1), (3, "i32", OPS[c])])
                   for c in codes]
        model = fb.table([(0, "u32", 3), (1, "off", fb.offsets(opcodes)),
                          (2, "off", fb.offsets([subgraph])),
                          (3, "off", fb.string("yolo_dual_tpu_torch")),
                          (4, "off", fb.offsets(buffers))])
        return fb.finish(model, b"TFL3")


def default_frames(imgsz: int):
    """JAX's representative dataset without rep_images (export.py:113-115):
    16 draws of uniform [0, 1) (1, imgsz, imgsz, 3) frames from
    np.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 1, (1, imgsz, imgsz, 3)).astype(np.float32) for _ in range(16)]


def representative(images, imgsz: int):
    """rep_images as JAX's _rep reads them (HWC or NHWC, uint8 /255 or
    float), else default_frames."""
    if images is None:
        return default_frames(imgsz)
    out = []
    for im in images:
        im = np.asarray(im)
        im = im[None] if im.ndim == 3 else im
        out.append(im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else
                   im.astype(np.float32))
    return out


@torch.inference_mode()
def calibrate(g: TfGraph, frames, device) -> Dict[str, Tuple[float, float]]:
    """{value: (min, max)} of every value of `g` over NHWC float `frames`,
    the graph run with torch on `device`."""
    lo: Dict[str, torch.Tensor] = {}
    hi: Dict[str, torch.Tensor] = {}

    def observe(name, t):
        if t.is_floating_point():
            mn, mx = t.min(), t.max()
            lo[name] = torch.minimum(lo[name], mn) if name in lo else mn
            hi[name] = torch.maximum(hi[name], mx) if name in hi else mx

    for f in frames:
        run_tf_graph(g, torch.from_numpy(np.ascontiguousarray(f)).to(device), observe)
    return {k: (float(lo[k]), float(hi[k])) for k in lo}


def write_tflite(g: TfGraph, out, ranges: Optional[Dict[str, Tuple[float, float]]] = None) -> Path:
    """Write `g` as a TFLite file at `out`: float32, or int8 where `ranges`
    (calibrate's) are given."""
    out = Path(out)
    out.write_bytes(_Writer(g, ranges).build(ranges is not None))
    return out
