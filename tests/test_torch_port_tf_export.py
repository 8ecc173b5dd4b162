"""Weights out as TF files: the port's SavedModel (yolo_dual_tpu_torch/io/
savedmodel.py) and TFLite writers (io/tflite.py), float and int8, through
its export CLI, against the port's forward and the JAX package's files
(root export.py: jax2tf and TF's converter).

Tolerances: the port's SavedModel `.f` within 1e-4 of the port's forward
(TF's CPU kernels sum in their own order; pred's coordinates reach ~64),
its float TFLite within 1e-3 (TFLite's kernels sum in theirs), both within
tests/test_export.py's 1e-3 of JAX's files of the same weights, with and
without --fuse. int8: finite, the float file's shapes, and JAX's criterion
(tests/test_export.py: corrcoef of pred with the float forward > 0.8); the
correlation of the port's int8 pred with JAX's int8 file is printed.

Coverage is JAX's: its export_savedmodel writes Segment models, the DCNv3
one included (jax2tf serialises its forward), and raises on Detect and
semantic models; the port writes and refuses the same.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (IMGSZ, ORBAX_FIXTURE, ROOT, TINY_SEG, orbax_fixture_cfg,
                               primed_tiny, random_variables)
from yolo_dual_tpu.io.multibackend import MultiBackend as JaxMultiBackend
from yolo_dual_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.train import load_checkpoint as jax_load_checkpoint
from yolo_dual_tpu_torch import export as port_export
from yolo_dual_tpu_torch.io.multibackend import MultiBackend
from yolo_dual_tpu_torch.io.tf_graph import build_tf_graph, run_tf_graph
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model

tf = pytest.importorskip("tensorflow")

ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
EXPORT_TINY = dict(  # tests/test_export.py:_tiny_model
    nc=2, depth_multiple=0.33, width_multiple=0.125, anchors=ANCHORS,
    backbone=[[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "C3", [128]],
              [-1, 1, "Conv", [256, 3, 2]], [-1, 1, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
              [-1, 1, "C3", [512]], [-1, 1, "Conv", [1024, 3, 2]], [-1, 1, "C3", [1024]],
              [-1, 1, "SPPF", [1024, 5]]],
    head=[[-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
          [[-1, 6], 1, "Concat", [1]], [-1, 1, "C3", [512, False]], [-1, 1, "Conv", [256, 1, 1]],
          [-1, 1, "nn.Upsample", [None, 2, "nearest"]], [[-1, 4], 1, "Concat", [1]],
          [-1, 1, "C3", [256, False]], [-1, 1, "Conv", [256, 3, 2]], [[-1, 14], 1, "Concat", [1]],
          [-1, 1, "C3", [512, False]], [-1, 1, "Conv", [512, 3, 2]], [[-1, 10], 1, "Concat", [1]],
          [-1, 1, "C3", [1024, False]], [[17, 20, 23], 1, "Segment", ["nc", "anchors", 8, 32]]])


def _jax_export():
    import importlib.util
    spec = importlib.util.spec_from_file_location("jax_export_for_tf_tests", ROOT / "export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name):
    """(JAX model, its variables, config) of each case: the primed TINY_SEG,
    tests/test_export.py's tiny config on seeded weights (random BatchNorm
    statistics, so folding is a real test), and the committed DCNv3
    fixture's EMA (yolov5n-seg with C3_DCNV3 rows, width 1/16)."""
    if name == "tiny_seg":
        jm, v = primed_tiny()
        return jm, v, TINY_SEG
    if name == "export_tiny":
        jm = JaxSegmentationModel(EXPORT_TINY)
        return jm, random_variables(lambda k, x: jm.module.init(k, x, train=False),
                                    (1, IMGSZ, IMGSZ, 3), seed=21), EXPORT_TINY
    cfg = orbax_fixture_cfg()
    return JaxSegmentationModel(cfg), jax_load_checkpoint(ORBAX_FIXTURE / "ckpt")["ema"]["ema"], cfg


@pytest.fixture(scope="module", params=["tiny_seg", "export_tiny", "dcnv3"])
def files(request, tmp_path_factory):
    """For one config: JAX's SavedModel and TFLite of the weights, unfused and
    folded (JAX's run folds before export on --fuse); the port's files
    through its export CLI's functions; a seeded frame; the port's forward."""
    jexport = _jax_export()
    jm, v, cfg = config(request.param)
    root = tmp_path_factory.mktemp(request.param)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    model.eval()
    out = {"model": model, "cfg": cfg, "root": root}
    for fuse in (False, True):
        jmf, vf = jm.fuse(v) if fuse else (jm, v)
        sm = jexport.export_savedmodel(jmf, vf, IMGSZ, root / f"jax_sm_{fuse}")
        out[("jax", "savedmodel", fuse)] = sm
        out[("jax", "tflite", fuse)] = jexport.export_tflite(sm, root / f"jax_{fuse}.tflite",
                                                             imgsz=IMGSZ)
        out[("port", "savedmodel", fuse)] = port_export.export_savedmodel(
            model, IMGSZ, root / f"port_sm_{fuse}", fuse=fuse)
    out[("port", "tflite")] = port_export.export_tflite(model, IMGSZ, root / "port.tflite")
    x = np.random.default_rng(12).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with torch.no_grad():
        pred, protos, _ = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    out.update(x=x, pred=pred.numpy(), protos=protos.permute(0, 2, 3, 1).numpy(), jm=jm, v=v,
               jexport=jexport)
    return out


def run_savedmodel(path, x):
    out = tf.saved_model.load(str(path)).f(tf.constant(x))
    return out["pred"].numpy(), out["protos"].numpy()


def run_tflite(path, x):
    interp = tf.lite.Interpreter(model_path=str(path))
    interp.allocate_tensors()
    interp.set_tensor(interp.get_input_details()[0]["index"], x)
    interp.invoke()
    return sorted((interp.get_tensor(d["index"]) for d in interp.get_output_details()), key=np.ndim)


@pytest.mark.parametrize("fuse", [False, True])
def test_savedmodel_matches_forward_and_jax(files, fuse):
    """tf.saved_model.load(dir).f(x) on the port's directory: JAX's
    contract ({"pred": (1, N, no), "protos": NHWC}), the port's forward
    within 1e-4 and JAX's file within 1e-3; the serving_default signature
    gives the same; saved_model.pb parses with TF's own protobuf classes,
    tagged "serve", BatchNorms kept unless --fuse."""
    from tensorflow.core.protobuf import saved_model_pb2
    x = files["x"]
    path = files[("port", "savedmodel", fuse)]
    pred, protos = run_savedmodel(path, x)
    assert pred.shape == files["pred"].shape and protos.shape == files["protos"].shape
    np.testing.assert_allclose(pred, files["pred"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(protos, files["protos"], rtol=1e-4, atol=1e-4)
    want_pred, want_protos = run_savedmodel(files[("jax", "savedmodel", fuse)], x)
    np.testing.assert_allclose(pred, want_pred, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(protos, want_protos, rtol=1e-3, atol=1e-3)
    sig = tf.saved_model.load(str(path)).signatures["serving_default"](x=tf.constant(x))
    np.testing.assert_array_equal(sig["pred"].numpy(), pred)
    sm = saved_model_pb2.SavedModel.FromString((path / "saved_model.pb").read_bytes())
    meta = sm.meta_graphs[0]
    assert list(meta.meta_info_def.tags) == ["serve"]
    assert set(meta.signature_def["serving_default"].outputs) == {"pred", "protos"}
    ops = {n.op for f in meta.graph_def.library.function for n in f.node_def}
    assert ("FusedBatchNormV3" in ops) is not fuse


@pytest.mark.parametrize("fuse", [False, True])
def test_tflite_matches_forward_and_jax(files, fuse):
    """The port's float TFLite file (conv+BN folded, as TF's converter folds
    them) in tf.lite.Interpreter: pred rank 3 and protos rank 4, the port's
    forward within 1e-3 and JAX's file (of the unfused and of the folded
    SavedModel) within 1e-3."""
    x = files["x"]
    pred, protos = run_tflite(files[("port", "tflite")], x)
    np.testing.assert_allclose(pred, files["pred"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(protos, files["protos"], rtol=1e-3, atol=1e-3)
    want_pred, want_protos = run_tflite(files[("jax", "tflite", fuse)], x)
    np.testing.assert_allclose(pred, want_pred, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(protos, want_protos, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["savedmodel", "tflite"])
def test_both_multibackends_serve_the_port_files(files, kind):
    """The port's MultiBackend (NCHW in, protos NCHW out) and JAX's (NHWC)
    serve the port's files as the port's forward, within 1e-3."""
    path = files[("port", "savedmodel", True)] if kind == "savedmodel" else files[("port", "tflite")]
    x = files["x"]
    mb = MultiBackend(path)
    assert mb.kind == kind
    pred, protos = mb(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(pred.numpy(), files["pred"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(protos.permute(0, 2, 3, 1).numpy(), files["protos"], rtol=1e-3,
                               atol=1e-3)
    jpred, jprotos = JaxMultiBackend(path).forward(x)
    np.testing.assert_allclose(np.asarray(jpred), files["pred"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jprotos), files["protos"], rtol=1e-3, atol=1e-3)


def test_int8_tflite_passes_jax_criterion(files):
    """--int8 on JAX's 16 default frames, calibrated with the graph's ops in
    torch on the CPU: finite, the float file's shapes, corrcoef with the
    float forward > 0.8 (JAX's criterion); the correlation with JAX's int8
    file of the same weights printed."""
    root, x = files["root"], files["x"]
    q = port_export.export_tflite(files["model"], IMGSZ, root / "port_int8.tflite", int8=True,
                                  device="cpu")
    pred, protos = run_tflite(q, x)
    assert pred.shape == files["pred"].shape and protos.shape == files["protos"].shape
    assert np.isfinite(pred).all() and np.isfinite(protos).all()
    corr = np.corrcoef(pred.ravel(), files["pred"].ravel())[0, 1]
    assert corr > 0.8
    jq = files["jexport"].export_tflite(files[("jax", "savedmodel", False)], root / "jax_int8.tflite",
                                        int8=True, imgsz=IMGSZ)
    jpred, _ = run_tflite(jq, x)
    print(f"int8 pred corrcoef: port vs float forward {corr:.6f}, JAX's vs float forward "
          f"{np.corrcoef(jpred.ravel(), files['pred'].ravel())[0, 1]:.6f}, port vs JAX's "
          f"{np.corrcoef(pred.ravel(), jpred.ravel())[0, 1]:.6f}")


def test_lowered_graph_equals_forward(files):
    """io/tf_graph.py's NHWC graph run with torch (the int8 calibration's
    forward) equals the port's model forward within 1e-5 relative, folded and
    not (the DCNv3 sampling as gathers included)."""
    x = torch.from_numpy(files["x"])
    for fuse in (False, True):
        out = run_tf_graph(build_tf_graph(files["model"], IMGSZ, fuse=fuse), x)
        np.testing.assert_allclose(out["pred"].numpy(), files["pred"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["protos"].numpy(), files["protos"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["detect", "semantic"])
def test_export_refuses_what_jax_refuses(tmp_path, kind):
    """JAX's export_savedmodel unpacks `pred, protos, _` from the forward:
    a Detect model (2 values) and a semantic one (1) raise ValueError there
    (known and not a fault: JAX's export serves Segment models); the port's
    export raises the same ValueError and writes nothing."""
    from test_torch_parity import tiny_cfg
    from test_torch_port_export import SEGMENT_HEAD
    cls, cfg, n = ((JaxDetectionModel, tiny_cfg(False), 2) if kind == "detect" else
                   (JaxSemanticSegModel, SEGMENT_HEAD, 1))
    jm = cls(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), 1)
    msg = rf"not enough values to unpack \(expected 3, got {n}\)"
    with pytest.raises(ValueError, match=msg):
        _jax_export().export_savedmodel(jm, v, IMGSZ, tmp_path / "jax_sm")
    model = build_model(cfg, device="cpu").eval()
    for fn in (port_export.export_savedmodel, port_export.export_tflite):
        with pytest.raises(ValueError, match=msg):
            fn(model, IMGSZ, tmp_path / "port")
    assert not (tmp_path / "port").exists()


BLOCKED = ("tensorflow", "orbax", "orbax.checkpoint", "tensorstore", "flatbuffers",
           "google.protobuf", "jax")


def test_every_format_written_without_tf_orbax_protobuf(tmp_path):
    """In a process where tensorflow, orbax, tensorstore, flatbuffers,
    google.protobuf and jax cannot be imported (None in sys.modules), the
    package writes an orbax checkpoint, strips it, and exports .pt, ONNX, a
    SavedModel and float and int8 TFLite files; this process then reads
    each with orbax and TF."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_SEG))
    script = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
import numpy as np
from yolo_dual_tpu_torch import export
from yolo_dual_tpu_torch.io import ocdbt
from yolo_dual_tpu_torch.train.checkpoint import strip_optimizer
ocdbt.save_checkpoint({str(tmp_path / 'ck')!r}, {{"variables": {{"w": np.ones(3, np.float32)}},
                      "ema": {{"ema": {{"w": np.zeros(3, np.float32)}}}}, "opt_state": [{{}}],
                      "epoch": 2}})
strip_optimizer({str(tmp_path / 'ck')!r})
for int8 in (False, True):
    export.run(cfg={str(cfg)!r}, imgsz={IMGSZ}, include=("torchpt", "onnx", "savedmodel", "tflite"),
               out_dir={str(tmp_path)!r} + f"/out{{int(int8)}}", int8=int8, device="cpu")
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=ROOT, timeout=600)
    import orbax.checkpoint as ocp
    tree = ocp.PyTreeCheckpointer().restore(tmp_path / "ck")
    assert tree["epoch"] == -1 and tree["opt_state"] is None
    np.testing.assert_array_equal(tree["variables"]["w"], np.zeros(3, np.float32))
    x = np.random.default_rng(0).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    for k in (0, 1):
        out = tmp_path / f"out{k}"
        assert (out / "tiny.pt").is_file() and (out / "tiny.onnx").is_file()
        pred, protos = run_savedmodel(out / "tiny_saved_model", x)
        qpred, qprotos = run_tflite(out / "tiny.tflite", x)
        assert qpred.shape == pred.shape and qprotos.shape == protos.shape
        assert np.isfinite(qpred).all()
