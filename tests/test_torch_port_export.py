"""Weights and graphs out: the port's ONNX writer (yolo_dual_tpu_torch/io/
onnx_export.py) and export CLI (yolo_dual_tpu_torch/export.py) against the
JAX package's.

ONNX files run in cv2.dnn, the runtime both machines have. Tolerances: those
of tests/test_onnx_export.py (pred atol 2e-3 / rtol 1e-3, protos and the
semantic scores 1e-3 / 1e-3), against the port's forward and against JAX's
file for the same weights; the port's file is also compared with JAX's byte
for byte. The exported `.pt` in JAX's forward: 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import tiny_cfg
from torch_port_common import IMGSZ, TINY_SEG, orbax_fixture_cfg, primed_tiny, random_variables
from yolo_dual_tpu.io import import_torch_state_dict, load_torch_checkpoint
from yolo_dual_tpu.io.onnx_export import export_onnx as jax_export_onnx
from yolo_dual_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.train import save_checkpoint
from yolo_dual_tpu_torch import export as port_export
from yolo_dual_tpu_torch.io.onnx_export import SUPPORTED, export_onnx
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model

cv2 = pytest.importorskip("cv2")

SEMANTIC = dict(  # every semantic op of the writer (tests/test_onnx_export.py:92)
    nc=5, compiler="semantic", activation="relu",
    backbone=[[-1, 1, "ResNetStem", [8]], [-1, 1, "ResNet50Layer", [16, 2, 1]],
              [-1, 1, "ResNet18Layer", [24, 2, 2]], [-1, 1, "VGGBlock", [24, 2, True]]],
    head=[[-1, 1, "Conv", [16, 1, 1]], [-1, 1, "Upsample", [None, 2, "nearest"]],
          [2, 1, "Conv", [16, 1, 1]], [[-1, -2], 1, "Concat", [1]], [-1, 3, "C3", [16, False]],
          [-1, 1, "C3", [16, 2, True]], [[1, -1], 1, "Concat", [1]], [-1, 1, "Conv", [5, 1, 1]],
          [-1, 1, "nn.Softmax", [1]]])
SEGMENT_HEAD = dict(  # resnet18's head family (tests/test_onnx_export.py:142)
    nc=4, compiler="semantic", activation="relu",
    backbone=[[-1, 1, "ResNetStem", [8]], [-1, 1, "ResNet18Layer", [8, 1, 1]],
              [-1, 1, "ResNet18Layer", [16, 1, 2]], [-1, 1, "ResNet18Layer", [24, 1, 2]]],
    head=[[[1, 2, 3], 1, "SegmentHead", [4, 8]]])
CASES = {  # name: (JAX model class, config, nc)
    "detect": (JaxDetectionModel, tiny_cfg(False), 4),
    "segment": (JaxSegmentationModel, tiny_cfg(True), 4),
    "semantic": (JaxSemanticSegModel, SEMANTIC, 5),
    "segment_head": (JaxSemanticSegModel, SEGMENT_HEAD, 4),
}


def jax_and_port(name, seed):
    """JAX's model of case `name` with seeded variables (random BatchNorm
    statistics, so the fold is a real test) and the port's model of the same
    weights on the CPU."""
    cls, cfg, nc = CASES[name]
    jm = cls(cfg, nc=nc)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), seed)
    model = build_model(cfg, nc=nc, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, model.eval()


def onnx_fields(buf):
    """The top-level fields of a protobuf message: [(field, value)], a varint
    as an int, a length-delimited or fixed32 field as bytes."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        out.append((field, value))
    return out


def _varint(buf, i):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n, i
        shift += 7


def assert_same_graph(ours: bytes, theirs: bytes):
    """Two ONNX files hold the same model: every field equal byte for byte
    but the initializers' float32 data, which the two packages' conv+BN folds
    may round apart (held within rtol 1e-5, atol 1e-7; int64 data equal).
    Returns the number of initializer values that differ."""
    a, b = onnx_fields(ours), onnx_fields(theirs)
    assert [f for f, _ in a] == [f for f, _ in b]
    differ = 0
    for (f, va), (_, vb) in zip(a, b):
        if f != 7:  # ir_version, producer, opset
            assert va == vb
            continue
        ga, gb = onnx_fields(va), onnx_fields(vb)
        assert [g for g, _ in ga] == [g for g, _ in gb]
        for (g, xa), (_, xb) in zip(ga, gb):
            if g != 5:  # nodes (their attributes too), name, inputs, outputs
                assert xa == xb
                continue
            ta, tb = onnx_fields(xa), onnx_fields(xb)
            assert [t for t in ta if t[0] != 9] == [t for t in tb if t[0] != 9]
            dtype = np.int64 if dict(ta)[2] == 7 else np.float32
            da, db = (np.frombuffer(dict(t)[9], dtype) for t in (ta, tb))
            if dtype == np.int64:
                np.testing.assert_array_equal(da, db)
            else:
                np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-7)
                differ += int((da != db).sum())
    return differ


def run_cv2(path, x, names):
    net = cv2.dnn.readNetFromONNX(str(path))
    net.setInput(x, "images")
    return net.forward(names)


@pytest.mark.parametrize("name", sorted(CASES))
def test_onnx_matches_port_forward_and_jax_file(tmp_path, name):
    """Mirrors tests/test_onnx_export.py:35, :59, :92 and :142: the port's file
    loads in cv2.dnn and gives the port's forward; JAX's file of the same
    weights is the same graph, node for node and name for name, and the same
    weights but for the last bits of a few folded values (conv+BN folded in
    JAX's arithmetic and torch's): the files are byte-identical where no folded
    value rounds apart, as in the segment_head case here."""
    jm, v, model = jax_and_port(name, seed=len(name))
    ours = export_onnx(model, IMGSZ, tmp_path / "port.onnx")
    theirs = jax_export_onnx(jm, v, IMGSZ, tmp_path / "jax.onnx")
    assert ours.stat().st_size > 10_000
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, IMGSZ, IMGSZ)).astype(np.float32)
    semantic = CASES[name][1].get("anchors") is None
    names = ["seg"] if semantic else (["pred", "protos"] if name == "segment" else ["pred"])
    got = run_cv2(ours, x, names)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    want = [out] if semantic else [out[0]] + ([out[1]] if name == "segment" else [])
    for g, w, n in zip(got, want, names):
        tol = dict(atol=2e-3, rtol=1e-3) if n == "pred" else dict(atol=1e-3, rtol=1e-3)
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g, w.numpy(), **tol)
    for g, w in zip(got, run_cv2(theirs, x, names)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    differ = assert_same_graph(ours.read_bytes(), theirs.read_bytes())
    assert (differ == 0) == (ours.read_bytes() == theirs.read_bytes())
    print(f"{name}: {differ} folded weight values differ from JAX's file in their last bits")


def test_onnx_unsupported_module_message(tmp_path):
    """Mirrors tests/test_onnx_export.py:59: a layer outside SUPPORTED raises
    the message JAX's writer raises; a C3_DCNV3 config too."""
    cfg = tiny_cfg(False)
    cfg["backbone"][2] = [-1, 1, "GhostConv", [16, 1, 1]]
    model = build_model(cfg, nc=4, device="cpu")
    jm = JaxDetectionModel(cfg, nc=4)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), 1)
    with pytest.raises(NotImplementedError) as want:
        jax_export_onnx(jm, v, IMGSZ, tmp_path / "x.onnx")
    with pytest.raises(NotImplementedError, match="GhostConv") as got:
        export_onnx(model, IMGSZ, tmp_path / "x.onnx")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="C3_DCNV3"):
        export_onnx(build_model(orbax_fixture_cfg(), device="cpu"), 640, tmp_path / "d.onnx")
    assert not (tmp_path / "x.onnx").exists() and "Segment" in SUPPORTED


def test_exported_pt_loads_in_port_and_jax(tmp_path):
    """export.py --include torchpt from an orbax checkpoint of the primed
    TINY_SEG: the file is {"model", "format"}, unfused, loads strictly in the
    port and through JAX's load_torch_checkpoint + import_torch_state_dict
    (strict), and both give JAX's forward of the checkpoint's weights."""
    jm, v = primed_tiny()
    ckpt = save_checkpoint(tmp_path / "ckpt", {"variables": v})
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_SEG))
    out = port_export.run(weights=str(ckpt), cfg=str(cfg), imgsz=IMGSZ,
                          out_dir=str(tmp_path / "export"))["torchpt"]
    assert out.name == "tiny.pt"
    blob = torch.load(out, weights_only=True)
    assert blob["format"] == "yolo_dual_tpu-state_dict"
    assert any(k.endswith("bn.running_var") for k in blob["model"])
    model = build_model(str(cfg), device="cpu")
    model.load_state_dict(blob["model"], strict=True)
    jv = import_torch_state_dict(jax.tree_util.tree_map(np.zeros_like, v), load_torch_checkpoint(out),
                                 spec=jm.spec, strict=True)
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, jnp.asarray(x), train=False)
        back = jm.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        pred, protos, _ = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got in (pred.numpy(), np.asarray(back[0])):
        np.testing.assert_allclose(got, np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-4)


def test_export_cli(tmp_path, monkeypatch):
    """The CLI's flags are JAX's (export.py:156-172); a semantic config takes
    the semantic route with --nc; savedmodel and tflite of a semantic model
    raise ValueError as JAX's export_savedmodel does (its unpacking of
    pred, protos, _), writing neither; a Segment config writes
    `<stem>_saved_model/` (with --fuse, no BatchNorm left in it) and
    `<stem>.tflite`; every format of the table is written."""
    opt = port_export.parse_opt([])
    assert (opt.weights, opt.cfg, opt.nc, opt.imgsz, opt.include, opt.fuse, opt.int8) == \
        ("", "yolov5s-seg.json", None, 640, ["torchpt"], False, False)
    cfg = tmp_path / "sem.json"
    cfg.write_text(json.dumps(dict(SEGMENT_HEAD, head=[[[1, 2, 3], 1, "SegmentHead", ["nc", 8]]])))
    out = port_export.run(**vars(port_export.parse_opt(
        ["--cfg", str(cfg), "--nc", "6", "--imgsz", str(IMGSZ), "--include", "torchpt", "onnx",
         "--out-dir", str(tmp_path / "e")])))
    assert sorted(out) == ["onnx", "torchpt"]
    seg = run_cv2(out["onnx"], np.zeros((1, 3, IMGSZ, IMGSZ), np.float32), ["seg"])[0]
    assert seg.shape == (1, 6, IMGSZ, IMGSZ)
    assert torch.load(out["torchpt"], weights_only=True)["model"]["model.4.final1.conv.weight"] \
        .shape[0] == 6
    for fmt in ("savedmodel", "tflite"):
        with pytest.raises(ValueError, match=r"not enough values to unpack \(expected 3, got 1\)"):
            port_export.run(cfg=str(cfg), include=(fmt,), out_dir=str(tmp_path / fmt))
        assert not any((tmp_path / fmt).iterdir())
    seg = tmp_path / "tiny.json"
    seg.write_text(json.dumps(TINY_SEG))
    logged = []
    monkeypatch.setattr(port_export.LOGGER, "info", logged.append)
    out = port_export.run(**vars(port_export.parse_opt(
        ["--cfg", str(seg), "--imgsz", str(IMGSZ), "--include", "tflite", "--fuse",
         "--out-dir", str(tmp_path / "f")])))
    assert out == {"savedmodel": tmp_path / "f" / "tiny_saved_model",
                   "tflite": tmp_path / "f" / "tiny.tflite"}
    assert (out["savedmodel"] / "saved_model.pb").is_file() and out["tflite"].is_file()
    assert b"FusedBatchNormV3" not in (out["savedmodel"] / "saved_model.pb").read_bytes()
    assert logged == [f"exported SavedModel -> {out['savedmodel']}",
                      f"exported TFLite -> {out['tflite']}"]
    assert [row[1] for row in port_export.export_formats() if row[3]] == \
        ["orbax", "torchpt", "onnx", "savedmodel", "tflite"]
