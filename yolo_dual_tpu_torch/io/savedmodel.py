"""TF SavedModel writer with no TensorFlow installed (port of the JAX
package's root export.py:72 export_savedmodel, which converts through
jax2tf).

    write_savedmodel(build_tf_graph(model, 640, fuse=True), "m_saved_model")
    tf.saved_model.load("m_saved_model").f(x)   # {"pred": ..., "protos": ...}

The contract is JAX's: a tf.Module whose function `f` takes NHWC float32
(1, imgsz, imgsz, 3) in [0, 1] and returns {"pred": (1, N, no), "protos":
(1, mh, mw, nm)}, with a `serving_default` signature of the same. The
directory holds:

- `saved_model.pb`: SavedModel { MetaGraphDef tagged "serve": a GraphDef
  (Placeholder `serving_default_x` -> PartitionedCall of the signature
  function) whose FunctionDefLibrary holds `f`'s body, the TfGraph's ops as
  TF NodeDefs with the weights as Const nodes, and the signature wrapper that
  calls it; the `serving_default` SignatureDef; and a SavedObjectGraph whose
  root has the function `f` and the signature map, with their concrete
  functions' input and output structures };
- `variables/`: the TensorBundle tf.saved_model.load restores, holding only
  the object graph of the checkpoint (no variables: the weights are
  constants). Its index is a LevelDB table (one data block, an empty
  metaindex block, an index block and the 48-byte footer), each block with
  its type byte and masked CRC32C.

Messages are written with io/protowire.py; field numbers are TF's .proto
files' (tests/test_torch_port_tf_export.py parses every file with TF's own
protobuf classes and loads it with tf.saved_model.load).
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path
from typing import List

import numpy as np

from yolo_dual_tpu_torch.io.ocdbt import crc32c
from yolo_dual_tpu_torch.io.protowire import f_bytes, f_fixed32, f_float, f_int, f_map, f_str, varint
from yolo_dual_tpu_torch.io.tf_graph import TfGraph

DT = {"float32": 1, "int32": 3, "bool": 10, "string": 7}
F32 = DT["float32"]
GRAPH_PRODUCER = 1882        # a GraphDef version inside the range TF 2.x reads
FUNCTION = "__inference_f_10"
SIGNATURE = "__inference_signature_wrapper_20"
# each op's output argument (its OpDef), named in a FunctionDef's inputs
OUT_ARG = {"Const": "output", "Conv2D": "output", "DepthwiseConv2dNative": "output",
           "BiasAdd": "output", "FusedBatchNormV3": "y", "Sigmoid": "y",
           "Softmax": "softmax", "Floor": "y", "Mul": "z",
           "AddV2": "z", "Sub": "z", "Pow": "z", "Minimum": "z", "Maximum": "z", "Equal": "z",
           "Cast": "y", "ConcatV2": "output", "MaxPool": "output", "Pad": "output",
           "ResizeNearestNeighbor": "resized_images",
           "Reshape": "output", "Transpose": "y", "StridedSlice": "output",
           "GatherV2": "output", "Sum": "output", "Identity": "output",
           "PartitionedCall": "output"}
_SIMPLE = {"sigmoid": "Sigmoid", "softmax": "Softmax", "floor": "Floor",
           "mul": "Mul", "add": "AddV2", "sub": "Sub", "pow": "Pow", "minimum": "Minimum",
           "maximum": "Maximum"}


# -- framework messages --------------------------------------------------------

def shape_proto(shape) -> bytes:
    return b"".join(f_bytes(2, f_int(1, d)) for d in shape)


def tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    return (f_int(1, DT[str(arr.dtype)]) + f_bytes(2, shape_proto(arr.shape))
            + f_bytes(4, np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()))


def attr(kind: str, v) -> bytes:
    """An AttrValue: kind is type, shape, tensor, s, i, f, b, func, or
    list_i / list_type / list_shape."""
    if kind == "type":
        return f_int(6, DT[v] if isinstance(v, str) else v)
    if kind == "shape":
        return f_bytes(7, shape_proto(v))
    if kind == "tensor":
        return f_bytes(8, tensor_proto(v))
    if kind == "s":
        return f_bytes(2, v.encode() if isinstance(v, str) else v)
    if kind == "i":
        return f_int(3, v)
    if kind == "f":
        return f_float(4, v)
    if kind == "b":
        return f_int(5, int(v))
    if kind == "func":
        return f_bytes(10, f_str(1, v))
    if kind == "list_i":
        return f_bytes(1, b"".join(f_int(3, i) for i in v))
    if kind == "list_type":
        return f_bytes(1, b"".join(f_int(6, DT[t] if isinstance(t, str) else t) for t in v))
    if kind == "list_shape":
        return f_bytes(1, b"".join(f_bytes(7, shape_proto(s)) for s in v))
    raise ValueError(kind)


def _attrs(field: int, attrs: dict) -> bytes:
    """map<string, AttrValue>; `attrs` maps a name to (kind, value)."""
    return f_map(field, sorted(attrs.items()), lambda f, kv: f_bytes(f, attr(*kv)))


def node_def(name: str, op: str, inputs: List[str], attrs: dict) -> bytes:
    return (f_str(1, name) + f_str(2, op) + b"".join(f_str(3, i) for i in inputs)
            + _attrs(5, attrs))


class _Body:
    """A FunctionDef body: NodeDefs and the references ("node:out_arg:0")
    of the values they compute."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.ref = {}
        self._names = set()

    def add(self, name: str, op: str, inputs: List[str], attrs: dict, value=None) -> str:
        while name in self._names:
            name += "_"
        self._names.add(name)
        self.nodes.append(node_def(name, op, [self.ref.get(i, i) for i in inputs], attrs))
        ref = f"{name}:{OUT_ARG[op]}:0"
        if value is not None:
            self.ref[value] = ref
        return ref

    def const(self, arr: np.ndarray, name: str) -> str:
        arr = np.asarray(arr)
        return self.add(name, "Const", [], {"dtype": ("type", str(arr.dtype)),
                                             "value": ("tensor", arr)})


def _function_body(g: TfGraph, body: _Body) -> None:
    """TfGraph's nodes as TF NodeDefs (io/tf_graph.py's op list)."""
    for name, arr in g.consts.items():
        body.ref[name] = body.const(arr, name)
    for n in g.nodes:
        t = ("type", g.dtypes[n.inputs[0]])
        a, i, out = n.attrs, n.inputs, n.out
        if n.op == "conv":
            s, d = a["strides"], a["dilation"]
            conv_attrs = {"T": t, "strides": ("list_i", [1, s[0], s[1], 1]),
                          "padding": ("s", a["padding"]), "dilations": ("list_i", [1, d, d, 1]),
                          "data_format": ("s", "NHWC")}
            op = "DepthwiseConv2dNative" if a["depthwise"] else "Conv2D"
            if len(i) == 3:
                y = body.add(out + "/conv", op, i[:2], conv_attrs)
                body.add(out, "BiasAdd", [y, i[2]], {"T": t, "data_format": ("s", "NHWC")}, out)
            else:
                body.add(out, op, i, conv_attrs, out)
        elif n.op == "bn":
            body.add(out, "FusedBatchNormV3", i, {
                "T": t, "U": t, "epsilon": ("f", a["epsilon"]), "is_training": ("b", False),
                "data_format": ("s", "NHWC"), "exponential_avg_factor": ("f", 1.0)}, out)
        elif n.op in _SIMPLE:
            body.add(out, _SIMPLE[n.op], i, {"T": t}, out)
        elif n.op == "equal":
            body.add(out, "Equal", i, {"T": t, "incompatible_shape_error": ("b", True)}, out)
        elif n.op == "cast":
            body.add(out, "Cast", i, {"SrcT": t, "DstT": ("type", a["to"]),
                                      "Truncate": ("b", False)}, out)
        elif n.op == "concat":
            axis = body.const(np.int32(a["axis"]), out + "/axis")
            body.add(out, "ConcatV2", i + [axis], {"N": ("i", len(i)), "T": t,
                                                   "Tidx": ("type", "int32")}, out)
        elif n.op == "maxpool":
            k, s = a["k"], a["strides"]
            body.add(out, "MaxPool", i, {"T": t, "ksize": ("list_i", [1, k[0], k[1], 1]),
                                         "strides": ("list_i", [1, s[0], s[1], 1]),
                                         "padding": ("s", "SAME"),
                                         "data_format": ("s", "NHWC")}, out)
        elif n.op == "pad":
            body.add(out, "Pad", i, {"T": t, "Tpaddings": ("type", "int32")}, out)
        elif n.op == "resize_nearest":
            body.add(out, "ResizeNearestNeighbor", i, {
                "T": t, "align_corners": ("b", False), "half_pixel_centers": ("b", False)}, out)
        elif n.op == "reshape":
            body.add(out, "Reshape", i, {"T": t, "Tshape": ("type", "int32")}, out)
        elif n.op == "transpose":
            body.add(out, "Transpose", i, {"T": t, "Tperm": ("type", "int32")}, out)
        elif n.op == "slice":
            ones = body.const(np.ones(len(g.shapes[i[0]]), np.int32), out + "/strides")
            masks = {m: ("i", 0) for m in ("begin_mask", "end_mask", "ellipsis_mask",
                                           "new_axis_mask", "shrink_axis_mask")}
            body.add(out, "StridedSlice", i + [ones], {"T": t, "Index": ("type", "int32"),
                                                       **masks}, out)
        elif n.op == "gather":
            axis = body.const(np.int32(0), out + "/axis")
            body.add(out, "GatherV2", i + [axis], {
                "Tparams": t, "Tindices": ("type", "int32"), "Taxis": ("type", "int32"),
                "batch_dims": ("i", 0)}, out)
        elif n.op == "sum":
            body.add(out, "Sum", i, {"T": t, "Tidx": ("type", "int32"),
                                     "keep_dims": ("b", False)}, out)
        else:
            raise NotImplementedError(f"SavedModel: op {n.op}")


def _arg(name: str, dtype: int = F32) -> bytes:
    return f_str(1, name) + f_int(3, dtype)


def function_def(name: str, body: _Body, outputs: List[str], input_shape) -> bytes:
    """A FunctionDef of one float32 input `x` and float32 outputs `identity`,
    `identity_1`, ... returning the references `outputs`."""
    rets = []
    for k, ref in enumerate(outputs):
        rets.append(body.add("Identity" + (f"_{k}" if k else ""), "Identity", [ref],
                             {"T": ("type", "float32")}))
    names = ["identity" + (f"_{k}" if k else "") for k in range(len(outputs))]
    signature = (f_str(1, name) + f_bytes(2, _arg("x"))
                 + b"".join(f_bytes(3, _arg(n)) for n in names))
    arg_attr = f_bytes(7, f_int(1, 0) + f_bytes(2, _attrs(1, {
        "_user_specified_name": ("s", "x"), "_output_shapes": ("list_shape", [input_shape])})))
    return (f_bytes(1, signature) + b"".join(f_bytes(3, n) for n in body.nodes)
            + f_map(4, zip(names, rets), f_str)
            + _attrs(5, {"_input_shapes": ("list_shape", [input_shape]),
                         "_construction_context": ("s", "kEagerRuntime")})
            + arg_attr)


# -- the object graph's structures (struct.proto) -------------------------------

def _sv_none() -> bytes:
    return f_bytes(1, b"")


def _sv_str(s: str) -> bytes:
    return f_str(13, s)


def _sv_list(vals) -> bytes:
    return f_bytes(51, b"".join(f_bytes(1, v) for v in vals))


def _sv_tuple(vals) -> bytes:
    return f_bytes(52, b"".join(f_bytes(1, v) for v in vals))


def _sv_dict(items) -> bytes:
    return f_bytes(53, f_map(1, items, f_bytes))


def _sv_spec(shape, name: str = None) -> bytes:
    spec = (f_str(1, name) if name else b"") + f_bytes(2, shape_proto(shape)) + f_int(3, F32)
    return f_bytes(33, spec)


def _fullargspec(args, kwonly) -> bytes:
    pairs = [("args", _sv_list(map(_sv_str, args))), ("varargs", _sv_none()),
             ("varkw", _sv_none()), ("defaults", _sv_none()),
             ("kwonlyargs", _sv_list(map(_sv_str, kwonly))), ("kwonlydefaults", _sv_none()),
             ("annotations", _sv_dict([]))]
    values = b"".join(f_bytes(2, f_str(1, k) + f_bytes(2, v)) for k, v in pairs)
    return f_bytes(54, f_str(1, "FullArgSpec") + values)


def _user_object(identifier: str) -> bytes:
    return f_bytes(4, f_str(1, identifier) + f_bytes(2, f_int(1, 1) + f_int(2, 1)))


def _children(pairs) -> bytes:
    return b"".join(f_bytes(1, f_int(1, i) + f_str(2, n)) for i, n in pairs)


def object_graph(input_shape, out_shapes: dict) -> bytes:
    """SavedObjectGraph: 0 the root (children f, signatures), 1 the function
    f, 2 the signature map, 3 its serving_default; and both concrete
    functions' input and output structures."""
    outs = _sv_dict([(k, _sv_spec(s, k)) for k, s in sorted(out_shapes.items())])
    f_spec = f_bytes(1, _fullargspec(["x"], [])) + f_bytes(5, _sv_tuple([_sv_spec(input_shape)]))
    sig_spec = f_bytes(1, _fullargspec([], ["x"])) + f_bytes(5, _sv_none())
    nodes = [
        _children([(1, "f"), (2, "signatures")]) + _user_object("_generic_user_object"),
        f_bytes(6, f_str(1, FUNCTION) + f_bytes(2, f_spec)),
        _children([(3, "serving_default")]) + _user_object("signature_map"),
        f_bytes(8, f_str(1, SIGNATURE) + f_str(2, "x") + f_int(3, 1) + f_bytes(4, sig_spec)),
    ]
    concrete = {
        FUNCTION: f_bytes(3, _sv_tuple([_sv_tuple([_sv_spec(input_shape, "x")]), _sv_dict([])]))
        + f_bytes(4, outs),
        SIGNATURE: f_bytes(3, _sv_tuple([_sv_tuple([]),
                                         _sv_dict([("x", _sv_spec(input_shape, "x"))])]))
        + f_bytes(4, outs),
    }
    return b"".join(f_bytes(1, n) for n in nodes) + f_map(2, sorted(concrete.items()), f_bytes)


def checkpoint_object_graph() -> bytes:
    """The TrackableObjectGraph of variables/: the object graph's four nodes,
    none holding a value."""
    children = [[(1, "f"), (2, "signatures")], [], [(3, "serving_default")], []]
    return b"".join(f_bytes(1, _children(c) + f_bytes(5, b"")) for c in children)


# -- the TensorBundle of variables/ --------------------------------------------

TABLE_MAGIC = 0xDB4775248B80FB57


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _table_block(entries) -> bytes:
    """A LevelDB block, a restart point at every entry (no shared prefixes)."""
    body, restarts = b"", []
    for k, v in entries:
        restarts.append(len(body))
        body += varint(0) + varint(len(k)) + varint(len(v)) + k + v
    restarts = restarts or [0]
    return body + b"".join(struct.pack("<I", r) for r in restarts) + struct.pack("<I", len(restarts))


def sstable(entries) -> bytes:
    """A LevelDB table of sorted (key, value) entries in one data block."""
    out = b""
    handles = []
    for block in (_table_block(entries), _table_block([])):   # data, metaindex
        handles.append((len(out), len(block)))
        out += block + b"\0" + struct.pack("<I", masked_crc(block + b"\0"))
    data_handle = varint(handles[0][0]) + varint(handles[0][1])
    index = _table_block([(entries[-1][0], data_handle)])
    index_handle = (len(out), len(index))
    out += index + b"\0" + struct.pack("<I", masked_crc(index + b"\0"))
    footer = (varint(handles[1][0]) + varint(handles[1][1]) + varint(index_handle[0])
              + varint(index_handle[1]))
    return out + footer.ljust(40, b"\0") + struct.pack("<Q", TABLE_MAGIC)


def write_bundle(prefix: Path, strings: dict) -> None:
    """A TensorBundle (`prefix.index`, `prefix.data-00000-of-00001`) of
    scalar string tensors: a tensor's data is its varint length, the masked
    CRC32C of that length as a uint32, and its bytes."""
    data, entries = b"", []
    for key in sorted(strings):
        s = strings[key]
        length = struct.pack("<I", len(s))          # a length under 2^32 is summed as a uint32
        length_crc = struct.pack("<I", masked_crc(length))
        blob = varint(len(s)) + length_crc + s
        entry = (f_int(1, DT["string"]) + f_bytes(2, b"") + (f_int(4, len(data)) if data else b"")
                 + f_int(5, len(blob)) + f_fixed32(6, masked_crc(length + length_crc + s)))
        entries.append((key.encode(), entry))
        data += blob
    header = f_int(1, 1) + f_bytes(3, f_int(1, 1))     # one shard, little-endian, version 1
    prefix.with_name(prefix.name + ".index").write_bytes(sstable([(b"", header)] + entries))
    prefix.with_name(prefix.name + ".data-00000-of-00001").write_bytes(data)


# -- the SavedModel ------------------------------------------------------------

def write_savedmodel(g: TfGraph, out) -> Path:
    """Write `g` (io/tf_graph.py; a Segment model's graph with outputs pred
    and protos) as a SavedModel directory at `out`, replacing one there."""
    if set(g.outputs) != {"pred", "protos"}:
        raise ValueError(f"a SavedModel of JAX's contract returns pred and protos; the graph "
                         f"returns {sorted(g.outputs)}")
    out = Path(out)
    input_shape = g.shapes["x"]
    keys = sorted(g.outputs)                      # the flat order of the output dict
    out_shapes = {k: g.shapes[g.outputs[k]] for k in keys}

    body = _Body()
    body.ref["x"] = "x"
    _function_body(g, body)
    f_def = function_def(FUNCTION, body, [body.ref[g.outputs[k]] for k in keys], input_shape)
    wrapper = _Body()
    call = wrapper.add("PartitionedCall", "PartitionedCall", ["x"], {
        "Tin": ("list_type", ["float32"]), "Tout": ("list_type", ["float32"] * len(keys)),
        "f": ("func", FUNCTION)})
    refs = [call[:-1] + str(k) for k in range(len(keys))]
    sig_def = function_def(SIGNATURE, wrapper, refs, input_shape)
    library = f_bytes(1, f_def) + f_bytes(1, sig_def)
    graph = (f_bytes(1, node_def("serving_default_x", "Placeholder", [], {
        "dtype": ("type", "float32"), "shape": ("shape", input_shape)}))
        + f_bytes(1, node_def("PartitionedCall", "PartitionedCall", ["serving_default_x"], {
            "Tin": ("list_type", ["float32"]), "Tout": ("list_type", ["float32"] * len(keys)),
            "f": ("func", SIGNATURE)}))
        + f_bytes(2, library) + f_bytes(4, f_int(1, GRAPH_PRODUCER) + f_int(2, 12)))

    def tensor_info(name, shape):
        return f_str(1, name) + f_int(2, F32) + f_bytes(3, shape_proto(shape))

    signature = (f_map(1, [("x", tensor_info("serving_default_x:0", input_shape))], f_bytes)
                 + f_map(2, [(k, tensor_info(f"PartitionedCall:{j}", out_shapes[k]))
                             for j, k in enumerate(keys)], f_bytes)
                 + f_str(3, "tensorflow/serving/predict"))
    meta_info = f_str(4, "serve") + f_str(5, "2.21.0") + f_int(7, 1)
    meta_graph = (f_bytes(1, meta_info) + f_bytes(2, graph)
                  + f_map(5, [("serving_default", signature)], f_bytes)
                  + f_bytes(7, object_graph(input_shape, out_shapes)))
    saved_model = f_int(1, 1) + f_bytes(2, meta_graph)

    tmp = out.with_name(out.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "variables").mkdir(parents=True)
    (tmp / "assets").mkdir()
    (tmp / "saved_model.pb").write_bytes(saved_model)
    write_bundle(tmp / "variables" / "variables",
                 {"_CHECKPOINTABLE_OBJECT_GRAPH": checkpoint_object_graph()})
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out
