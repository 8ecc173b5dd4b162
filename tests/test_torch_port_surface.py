"""Every keyword of the JAX package's public functions reaches the port.

The walk: every public function and class constructor defined in a JAX
module that has a counterpart in the port (`yolo_dual_tpu/<m>.py` ->
`yolo_dual_tpu_torch/<m>.py`), and the root CLIs' `run`, `train` and `main`
(`segment/`, `semantic/`, `classify/`, `serve.py`, `export.py` ->
`yolo_dual_tpu_torch/...`). The port's counterpart (the same name, or the
one COUNTERPARTS names) must accept every keyword JAX's accepts, and `**kw`
where JAX's takes it. What the port does not take stands in the exclusion
lists below, one line of reason a name; the walk prints how many it
excludes, and a stale entry fails.

Then the keywords JAX acts on, against JAX on the CPU: letterbox's `auto`,
`scaleFill`, `scaleup`, `stride` and `color`; intersect_dicts;
soft_nms_padded's `sigma`; initialize_detect_biases' `cf`;
DetectionModel's `anchors` and `verbose`; Conv's `bn` and `bias`;
SPPCSPC's `groups`; encode_overlap_masks' `areas_sorted`; ComputeLoss's
`autobalance`; predict_images(device_preprocess=False), JAX's host route;
and segment.val.run(save_dir=...), init_seeds(deterministic=True),
import_torch_state_dict(verbose=True) and the renamed keywords.
"""

import functools
import importlib
import importlib.util
import inspect
import json
import logging
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (IMGSZ, ROOT, TINY_NM, TINY_SEG, nhwc, port_model, primed_tiny,
                               random_variables, write_yolo_split)
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax

cv2 = pytest.importorskip("cv2")

JAX_PKG = ROOT / "yolo_dual_tpu"
NOT_OWED_MODULES = {  # ROADMAP A.7
    "utils/downloads.py": "sits behind the egress gate: the port downloads nothing",
    "nn/blocked.py": "TPU scheduling of the same math (space-to-depth stem)",
    "nn/blocked_train.py": "TPU scheduling of the same math (the blocked stem's training form)",
}
JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
                     if p.name != "__init__.py" and p.relative_to(JAX_PKG).as_posix()
                     not in NOT_OWED_MODULES)
ROOT_CLIS = ("segment/train.py", "segment/val.py", "segment/predict.py", "semantic/train.py",
             "semantic/val.py", "semantic/predict.py", "classify/train.py", "classify/val.py",
             "classify/predict.py", "serve.py", "export.py")
CLI_FUNCS = ("run", "train", "main")

# A JAX name whose port counterpart has another name or module.
COUNTERPARTS = {
    "io.weights.resolve_variables": "io.weights.resolve_state_dict",
    "kernels.dcn_sampling.use_pallas": "kernels.dcn_sampling.dcnv3_sampling",
    "kernels.dcn_sampling.dcnv3_core_pallas": "kernels.dcn_sampling.dcnv3_sampling",
    "kernels.dcn_sampling.dcnv3_bwd_dispatch": "kernels.dcn_sampling.dcnv3_sampling_backward",
    "models.model.BaseModel": "models.model.DetectionModel",
    "models.model.fuse_conv_bn": "nn.common.fuse_conv_bn",
    "models.model.scale_img_nhwc": "models.model.scale_img",
    "nn.common.Softmax": "torch.nn.Softmax",
    "nn.dcn.bilinear_sample_nhwc": "kernels.dcn_sampling.bilinear_sample_nhwc",
    "nn.dcn.dcnv3_coords": "kernels.dcn_sampling.dcnv3_coords",
    "nn.dcn.dcnv3_core": "kernels.dcn_sampling.dcnv3_core",
    "nn.dcn.dcnv3_core_bwd": "kernels.dcn_sampling.dcnv3_core_bwd",
    "utils.general.one_cycle": "train.optim.one_cycle",
}

# A JAX name with no port counterpart.
NO_COUNTERPART = {
    "kernels.augment.mosaic_warp_hsv_reference": "JAX's readable twin of its jitted kernel; "
                                                 "the port's mosaic_warp_hsv is plain torch",
    "nn.activations.silu": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.relu": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.leaky_relu": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.hardswish": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.mish": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.sigmoid": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.identity": "activations are torch.nn.functional's, by resolve_act",
    "nn.activations.frelu_pointwise": "JAX's relu fallback; FReLU is the module act_modules.FReLU",
    "nn.common.batch_norm": "flax's BatchNorm factory; the port's modules build BatchNorm2d",
    "nn.common.bn_config": "flax's BatchNorm profile context; the port's BatchNorms carry "
                           "their profile (GraphModel sets it)",
    "nn.common.fused_bn_vjp": "the flax BatchNorm VJP, TPU scheduling (ROADMAP A.7)",
    "nn.common.FusedBatchNorm": "the flax BatchNorm VJP, TPU scheduling (ROADMAP A.7)",
    "nn.common.fused_inference": "flax's fold context; the port folds in place, GraphModel.fuse",
    "nn.common.upsample_nearest": "torch's F.interpolate(mode='nearest'), in nn.common.Upsample",
    "ops.nms.nms_padded_serial": "a TPU scheduling variant of nms_padded (ROADMAP A.7)",
    "ops.nms.nms_padded_block": "a TPU scheduling variant of nms_padded (ROADMAP A.7)",
    "ops.nms.nms_padded_cluster": "a TPU scheduling variant of nms_padded (ROADMAP A.7)",
    "train.checkpoint.export_torch_state_dict": "the port's state_dict is already torch's",
    "train.optim.FusedOptState": "the optimizer state of JAX's fused TPU optax update",
}

# Keywords of flax modules' dataclass fields, excluded on every flax Module.
FLAX_FIELDS = {
    "parent": "flax's module tree",
    "name": "flax's module name in its tree",
    "dtype": "flax's compute dtype; the port's reduced precision is torch.autocast",
}

# Keywords excluded wherever they appear.
ANY_FUNCTION = {
    "variables": "a flax variable tree; the port's modules hold their weights",
    "params": "a flax parameter tree; the port's modules hold their weights",
    "batch_stats": "a flax statistics tree; the port's BatchNorms hold their statistics",
    "opt_state": "an optax state; the port's SmartOptimizer holds its state",
    "tx": "an optax transform; the port's optimizer is SmartOptimizer",
    "interpret": "Pallas's interpret mode; the port's plain versions run on CPU tensors",
}

# Keywords excluded on one function or class.
EXCLUDED = {
    "engine.autoshape.AutoShape:variables": "flax variables",
    "io.ensemble.Ensemble:model": "one flax module applied to each tree; the port takes models",
    "io.ensemble.Ensemble:variables_list": "flax trees; the port's members hold their weights",
    "io.ensemble.attempt_load:imgsz": "only flax's init probe",
    "io.torch_import.translate_torch_key:head_index": "JAX's hint moves no key in the port's "
                                                      "layout, which keeps Detect's convs",
    "io.torch_import.translate_torch_key:head_is_segment": "JAX's hint moves no key in the "
                                                           "port's layout",
    "io.torch_import.import_torch_state_dict:spec": "the port reads the model's own spec",
    "losses.ota.ComputeLossOTA:cand_capacity": "a static-shape capacity of XLA",
    "losses.ota.ComputeLossAuxOTA:cand_capacity": "a static-shape capacity of XLA",
    "losses.segment.ComputeSegmentLoss:pos_capacity": "a static-shape capacity of XLA",
    "models.compiler.build_module:name": "the port builds from the LayerSpec that holds it",
    "models.compiler.build_module:kwargs": "the port builds from the LayerSpec that holds them",
    "models.compiler.build_module:layer_name": "flax's module name",
    "models.model.GraphModel:fused": "the port folds in place (GraphModel.fuse)",
    "models.model.initialize_detect_biases:spec": "the port reads the model's own head",
    "models.model.ClassificationModel:dtype": "flax's compute dtype; the port's is "
                                              "torch.autocast",
    "models.model.fuse_conv_bn:eps": "the port folds with each BatchNorm's own eps",
    "models.compiler.build_module:dtype": "flax's compute dtype; the port's is torch.autocast",
    "kernels.dcn_sampling.dcnv3_bwd_dispatch:g_out": "the port's dispatch names the cotangent "
                                                     "grad_out (positional in both)",
    "nn.dcn.dcnv3_coords:h": "the port reads the output's height from the offset's shape",
    "nn.dcn.dcnv3_coords:w": "the port reads the output's width from the offset's shape",
    "models.model.reshape_classifier_output:imgsz": "only flax's init probe",
    "nn.dcn.DCNv3:impl": "JAX's choice of its Pallas kernel; the port's is the tensor's device",
    "parallel.mesh.make_mesh:axis": "a JAX mesh axis name",
    "parallel.mesh.make_mesh_2d:axes": "JAX mesh axis names",
    "parallel.mesh.batch_spec:spatial_dims": "JAX's PartitionSpec of the image dims; the "
                                             "port's bands are rows",
    "parallel.mesh.shard_batch:axis": "a JAX mesh axis name",
    "parallel.mesh.shard_batch:global_batch": "JAX's multi-host assembly of process-local "
                                              "rows; a torch rank keeps its own rows",
    "parallel.mesh.cross_replica_mean:axis": "a JAX mesh axis name; the port takes the mesh",
    "parallel.mesh.init_distributed:coordinator_address": "jax.distributed's; the port's is "
                                                          "init_method",
    "parallel.mesh.init_distributed:num_processes": "jax.distributed's; the port's is "
                                                    "world_size",
    "parallel.mesh.init_distributed:process_id": "jax.distributed's; the port's is rank",
    "train.checkpoint.load_checkpoint:target": "flax's restore target; torch.load needs none",
    "train.optim.param_group_label:path": "a flax tree path; the port labels torch names",
    "train.optim.smart_optimizer:fused": "JAX's fused TPU optax update, the same math",
    "train.trainer.Trainer:accumulate": "the port's SmartOptimizer accumulates, and the EMA "
                                        "steps on its real steps",
    "export.load_model:imgsz": "only flax's init probe",
    "export.export_torchpt:variables": "flax variables",
    "export.export_tflite:saved_model_dir": "the port writes TFLite from the model, not "
                                            "through a SavedModel",
}
# The keywords of JAX's model builders that steer flax and the TPU (JAX
# models/model.py:172 BaseModel; GraphModel's fields).
MODEL_BUILDER_KW = {
    "dtype": "flax's compute dtype; the port's reduced precision is torch.autocast",
    "blocked_stem": "TPU scheduling (nn/blocked_train.py)",
    "fused_bn": "the flax BatchNorm VJP, TPU scheduling",
    "fused_bn_act": "the flax BatchNorm VJP, TPU scheduling",
}
EXCLUDED.update({f"models.model.{m}:{k}": reason for m in (
    "BaseModel", "DetectionModel", "SegmentationModel", "SemanticSegModel", "GraphModel")
    for k, reason in MODEL_BUILDER_KW.items() if (m, k) != ("GraphModel", "dtype")})


def _port(dotted):
    """The object a dotted port name (or torch.nn.X) names."""
    if dotted.startswith("torch."):
        mod, _, attr = dotted.rpartition(".")
        return getattr(importlib.import_module(mod), attr)
    mod, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(f"yolo_dual_tpu_torch.{mod}"), attr)


def _load_root(rel):
    """A root CLI of the JAX package, loaded as the tests load it (segment/
    predict.py imports `val` from its own folder: its folder's val.py stands
    as `val` while it loads, and not after)."""
    folder = ROOT / rel.rsplit("/", 1)[0] if "/" in rel else ROOT
    name = "surface_" + rel.replace("/", "_")[:-3]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, str(ROOT / rel))
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        if rel.endswith("predict.py") and "/" in rel:
            mp.setitem(sys.modules, "val", _load_root(rel.rsplit("/", 1)[0] + "/val.py"))
        mp.syspath_prepend(str(folder))
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _keywords(obj):
    sig = inspect.signature(obj)
    kws = [p.name for p in sig.parameters.values() if p.kind in (p.POSITIONAL_OR_KEYWORD,
                                                                  p.KEYWORD_ONLY)]
    return kws, any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())


def _compare(key, jax_obj, port_obj, used):
    """The keywords of `jax_obj` that `port_obj` refuses and no list excludes."""
    jkw, jvar = _keywords(jax_obj)
    pkw, pvar = _keywords(port_obj)
    flax = inspect.isclass(jax_obj) and issubclass(jax_obj, fnn.Module)
    gaps = [] if pvar or not jvar else ["**kw"]
    for k in jkw:
        if pvar or k in pkw:
            continue
        for table, entry in ((EXCLUDED, f"{key}:{k}"), (ANY_FUNCTION, k),
                             (FLAX_FIELDS if flax else {}, k)):
            if entry in table:
                used.add((id(table), entry))
                break
        else:
            gaps.append(k)
    return gaps


@functools.lru_cache(maxsize=None)
def _walk():
    """{JAX module or CLI: [the gaps found]}, and the exclusions used."""
    gaps, used = {}, set()
    for rel in JAX_MODULES:
        mod = rel[:-3].replace("/", ".")
        jm = importlib.import_module(f"yolo_dual_tpu.{mod}")
        pm = importlib.import_module(f"yolo_dual_tpu_torch.{mod}")
        found = []
        for name, obj in vars(jm).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != jm.__name__ or not (
                    inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            key = f"{mod}.{name}"
            if key in NO_COUNTERPART:
                used.add((id(NO_COUNTERPART), key))
                continue
            if key in COUNTERPARTS:
                used.add((id(COUNTERPARTS), key))
                port_obj = _port(COUNTERPARTS[key])
            else:
                port_obj = getattr(pm, name, None)
                if port_obj is None:
                    found.append(f"{name}: no counterpart")
                    continue
            found += [f"{name}({k})" for k in _compare(key, obj, port_obj, used)]
        gaps[rel] = found
    for rel in ROOT_CLIS:
        jm = _load_root(rel)
        pm = importlib.import_module("yolo_dual_tpu_torch." + rel[:-3].replace("/", "."))
        found = []
        # the CLIs' entry points; serve.py's and export.py's every public function
        names = dict.fromkeys(CLI_FUNCS + tuple(
            n for n, o in vars(jm).items() if rel in ("serve.py", "export.py")
            and inspect.isfunction(o) and o.__module__ == jm.__name__ and not n.startswith("_")))
        for name in names:
            if not hasattr(jm, name):
                continue
            port_obj = getattr(pm, name, None)
            if port_obj is None:
                found.append(f"{name}: no counterpart")
                continue
            found += [f"{name}({k})" for k in _compare(rel[:-3].replace("/", ".") + "." + name,
                                                        getattr(jm, name), port_obj, used)]
        gaps[rel] = found
    return gaps, used


@pytest.mark.parametrize("rel", JAX_MODULES + list(ROOT_CLIS))
def test_port_accepts_every_jax_keyword(rel):
    gaps, _ = _walk()
    assert gaps[rel] == [], gaps[rel]


def test_every_exclusion_is_used(capsys):
    _, used = _walk()
    tables = {"COUNTERPARTS": COUNTERPARTS, "NO_COUNTERPART": NO_COUNTERPART,
              "EXCLUDED": EXCLUDED, "ANY_FUNCTION": ANY_FUNCTION, "FLAX_FIELDS": FLAX_FIELDS}
    stale = [f"{t}[{k!r}]" for t, table in tables.items() for k in table
             if (id(table), k) not in used]
    assert stale == []
    assert all(reason.strip() for table in tables.values() for reason in table.values())
    with capsys.disabled():
        print(f"\nsurface: {len(NOT_OWED_MODULES)} modules not owed, "
              f"{len(COUNTERPARTS)} names under another name, {len(NO_COUNTERPART)} without a "
              f"counterpart, {len(EXCLUDED) + len(ANY_FUNCTION) + len(FLAX_FIELDS)} keywords "
              f"excluded ({len(EXCLUDED)} on one function, {len(ANY_FUNCTION)} anywhere, "
              f"{len(FLAX_FIELDS)} flax fields)")


# ---------------------------------------------------------------------------
# The keywords JAX acts on, against JAX

LETTERBOX_SHAPES = ((37, 53), (64, 64), (100, 31), (17, 90), (33, 33))
LETTERBOX_KW = [dict(), dict(auto=True), dict(auto=True, stride=8), dict(scaleFill=True),
                dict(scaleup=False), dict(auto=True, scaleup=False), dict(color=(1, 2, 3)),
                dict(new_shape=(48, 80)), dict(new_shape=(48, 80), auto=True, stride=16),
                dict(new_shape=(80, 48), scaleFill=True)]


@pytest.mark.parametrize("kw", LETTERBOX_KW, ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                                       kw.items()) or "plain")
def test_letterbox_equals_jax(kw):
    from yolo_dual_tpu.data.augment import letterbox as jax_letterbox
    from yolo_dual_tpu_torch.data.augment import letterbox
    rng = np.random.default_rng(4)
    for h, w in LETTERBOX_SHAPES:
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        args = dict(new_shape=64, **kw) if "new_shape" not in kw else kw
        want, wr, wp = jax_letterbox(im, **args)
        got, gr, gp = letterbox(im, **args)
        assert got.shape == want.shape and gr == wr and gp == wp, (h, w)
        np.testing.assert_array_equal(got, want)
    # JAX's positional order
    got, _, _ = letterbox(im, 64, (5, 6, 7), True)
    np.testing.assert_array_equal(got, jax_letterbox(im, 64, (5, 6, 7), True)[0])
    gray = rng.integers(0, 256, (30, 50), dtype=np.uint8)
    np.testing.assert_array_equal(letterbox(gray, 64, 9)[0], jax_letterbox(gray, 64, 9)[0])


def test_intersect_dicts_equals_jax():
    from yolo_dual_tpu.utils.general import intersect_dicts as jax_intersect
    from yolo_dual_tpu_torch.utils.general import intersect_dicts
    da = {"a.weight": torch.zeros(3, 4), "b.bias": torch.zeros(4), "c.anchors": torch.zeros(2),
          "d": [[1, 2], [3, 4]], "e": np.zeros((2, 2))}
    db = {"a.weight": np.zeros((3, 4)), "b.bias": np.zeros(5), "c.anchors": torch.zeros(2),
          "d": np.zeros((2, 2)), "f": 1}
    for exclude in ((), ("anchors",), ("a.", "d")):
        assert list(intersect_dicts(da, db, exclude)) == list(jax_intersect(da, db, exclude))
    assert list(intersect_dicts(da, db)) == ["a.weight", "c.anchors", "d"]


@pytest.mark.parametrize("sigma", [0.3, 0.9])
def test_soft_nms_sigma_equals_jax(sigma):
    from yolo_dual_tpu.ops import nms as jax_nms
    from yolo_dual_tpu_torch.ops import nms
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 200, (2, 300, 2)).astype(np.float32)
    wh = rng.uniform(10, 60, (2, 300, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    keep, kept = nms.soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 100,
                                     sigma=sigma, score_threshold=0.25)
    other, _ = nms.soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 100,
                                   score_threshold=0.25)
    assert not torch.equal(keep, other)  # the decay is the sigma's
    for i in range(2):
        wk, ws = jax_nms.soft_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.3, 100,
                                         sigma=sigma, score_threshold=0.25)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(wk))
        np.testing.assert_allclose(kept[i].numpy(), np.asarray(ws), rtol=1e-6, atol=0)


def _narrow_seg():
    """yolov5n-seg at a quarter of its width (the JAX config's rows)."""
    cfg = yaml.safe_load((ROOT / "yolo_dual_tpu" / "configs" / "segment" / "yolov5n-seg.yaml")
                         .read_text())
    return dict(cfg, width_multiple=0.0625, nc=5)


def test_detect_biases_cf_and_anchors_equal_jax(caplog):
    from yolo_dual_tpu.models.model import SegmentationModel as JaxSeg
    from yolo_dual_tpu.models.model import initialize_detect_biases as jax_init_biases
    from yolo_dual_tpu_torch.models.model import SegmentationModel, initialize_detect_biases
    cfg = _narrow_seg()
    anchors = [[12, 14, 18, 30, 30, 26], [32, 60, 60, 48, 60, 120], [120, 90, 150, 200, 370, 330]]
    jm = JaxSeg(cfg, anchors=anchors)
    caplog.set_level(logging.INFO, logger="yolo_dual_tpu_torch")
    logger = logging.getLogger("yolo_dual_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        model = SegmentationModel(cfg, anchors=anchors, verbose=True, device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    rows = [r.getMessage() for r in caplog.records if r.getMessage()[:3].strip().isdigit()]
    assert len(rows) == len(cfg["backbone"]) + len(cfg["head"])
    head, jhead = model.model[-1], jm.spec.layers[-1].kw()
    assert [list(a) for a in jhead["anchors"]] == anchors
    np.testing.assert_allclose(np.asarray(head.anchors, np.float32).reshape(3, -1),
                               np.asarray(anchors, np.float32))
    assert list(head.strides) == list(jhead["strides"])
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=2)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    cf = np.array([5.0, 1.0, 3.0, 0.5, 7.0])
    jax_init_biases(v, jm.spec, cf=cf)
    initialize_detect_biases(model, cf=torch.from_numpy(cf))
    want = state_dict_from_flax(v)
    for i in range(3):
        key = f"model.{len(cfg['backbone']) + len(cfg['head']) - 1}.m.{i}.bias"
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), want[key].numpy())


@pytest.mark.parametrize("module", ["Conv_bias_no_bn", "SimConv_bias_no_bn", "SPPCSPC_groups2"])
def test_conv_and_sppcspc_keywords_equal_jax(module):
    from yolo_dual_tpu.nn import common as JC
    from yolo_dual_tpu.nn import spp as JS
    from yolo_dual_tpu_torch.nn import common as PC
    from yolo_dual_tpu_torch.nn import spp as PS
    jmod, pmod = {
        "Conv_bias_no_bn": (JC.Conv(12, 3, 2, bn=False, bias=True),
                            PC.Conv(8, 12, 3, 2, bn=False, bias=True)),
        "SimConv_bias_no_bn": (JS.SimConv(12, 3, bn=False, bias=True),
                               PS.SimConv(8, 12, 3, bn=False, bias=True)),
        "SPPCSPC_groups2": (JS.SPPCSPC(16, groups=2), PS.SPPCSPC(8, 16, groups=2)),
    }[module]
    x = np.random.default_rng(1).standard_normal((2, 9, 10, 8)).astype(np.float32)
    v = random_variables(lambda k, _: jmod.init(k, jnp.asarray(x), train=False), x.shape, seed=3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmod.apply(v, jnp.asarray(x), train=False))
    pmod.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = nhwc(pmod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if module != "SPPCSPC_groups2":
        assert pmod.bn is None and pmod.conv.bias is not None
    else:
        assert pmod.cv1.conv.groups == 2


def test_encode_overlap_masks_areas_sorted_equals_jax():
    from yolo_dual_tpu.losses.segment import encode_overlap_masks as jax_encode
    from yolo_dual_tpu_torch.losses.segment import encode_overlap_masks
    masks = np.zeros((3, 8, 8), np.uint8)
    masks[0, 1:3, 1:3] = 1
    masks[1, 0:7, 0:7] = 1
    masks[2, 2:6, 2:6] = 1
    for sort in (True, False):
        got, want = encode_overlap_masks(masks, areas_sorted=sort), jax_encode(masks, sort)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert not np.array_equal(encode_overlap_masks(masks, False)[0], encode_overlap_masks(masks)[0])


def test_compute_loss_autobalance_raises_as_jax():
    from yolo_dual_tpu.losses.detect import ComputeLoss as JaxComputeLoss
    from yolo_dual_tpu_torch.losses.detect import ComputeLoss
    args = ([[10, 13, 16, 30, 33, 23]] * 3, (8, 16, 32), 3, {})
    for cls in (JaxComputeLoss, ComputeLoss):
        cls(*args, autobalance=False)
        with pytest.raises(NotImplementedError, match="autobalance"):
            cls(*args, autobalance=True)


def test_predict_images_host_route_equals_jax(tmp_path):
    """device_preprocess=False: the host letterbox, as JAX's host route, on
    frames of three shapes; the default (None) is the letterbox kernel's
    route, whose plain version runs on the CPU."""
    from yolo_dual_tpu.engine.predictor import predict_images as jax_predict
    from yolo_dual_tpu.models.model import SegmentationModel as JaxSeg
    from yolo_dual_tpu_torch.engine.predictor import predict_images
    jm, v = primed_tiny()
    rng = np.random.default_rng(8)
    src = tmp_path / "frames"
    src.mkdir()
    for i, (h, w) in enumerate(((48, 64), (64, 30), (50, 50))):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im[h // 4:h // 2, w // 4:w // 2] = 230
        cv2.imwrite(str(src / f"f{i}.png"), im[..., ::-1])
    kw = dict(imgsz=IMGSZ, conf_thres=0.01, nm=TINY_NM, save_img=False)
    want = jax_predict(JaxSeg(TINY_SEG), v, str(src), device_preprocess=False, **kw)
    got = predict_images(port_model(v), str(src), device_preprocess=False, device="cpu", **kw)
    assert len(got) == len(want) == 3 and sum(len(g) for g in got) > 3
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)
    kernel_route = predict_images(port_model(v), str(src), device="cpu", **kw)
    assert len(kernel_route) == 3


def test_val_run_save_dir_and_the_ignored_keywords(tmp_path, monkeypatch):
    """segment.val.run(save_dir=...) writes there, as it stands; other
    keywords are ignored as JAX's run ignores them."""
    from yolo_dual_tpu_torch.segment import val as port_val
    _, v = primed_tiny()
    write_yolo_split(tmp_path, "val", 3, ((48, 64),), seed=4)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_SEG))
    weights = tmp_path / "tiny.pt"
    torch.save(state_dict_from_flax(v), weights)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "here"
    port_val.run(data=str(tmp_path / "port"), weights=str(weights), cfg=str(cfg), batch_size=2,
                 imgsz=IMGSZ, device="cpu", save_txt=True, save_dir=str(out),
                 not_a_flag_of_the_port=1)
    assert sorted(p.name for p in (out / "labels").glob("*.txt"))
    assert not (tmp_path / "runs").exists()


def test_init_seeds_deterministic_turns_torch_deterministic_mode_on(monkeypatch):
    from yolo_dual_tpu_torch.utils.general import init_seeds
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    try:
        init_seeds(3)
        assert not torch.are_deterministic_algorithms_enabled()
        assert init_seeds(3, deterministic=True) == 3
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        a = torch.rand(3)
        init_seeds(3, deterministic=True)
        assert torch.equal(a, torch.rand(3))
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


def test_import_verbose_and_the_renamed_keywords(tmp_path, caplog):
    """import_torch_state_dict(verbose=True) logs its counts as JAX's does;
    Detections(imgs=), replicate(tree=) and save_checkpoint(state_dict=)
    take JAX's keyword names."""
    from yolo_dual_tpu_torch.engine.autoshape import Detections
    from yolo_dual_tpu_torch.io.torch_import import import_torch_state_dict
    from yolo_dual_tpu_torch.parallel.mesh import make_mesh, replicate
    from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    _, v = primed_tiny()
    model = port_model(v)
    logger = logging.getLogger("yolo_dual_tpu_torch")
    logger.addHandler(caplog.handler)
    caplog.set_level(logging.INFO, logger="yolo_dual_tpu_torch")
    try:
        import_torch_state_dict(model, model.state_dict(), verbose=False)
        assert not [r for r in caplog.records if "torch import" in r.getMessage()]
        import_torch_state_dict(model, model.state_dict(), verbose=True)
        assert [r for r in caplog.records if "torch import: filled" in r.getMessage()]
    finally:
        logger.removeHandler(caplog.handler)
    ims = [np.zeros((4, 5, 3), np.uint8)]
    assert Detections(imgs=ims, dets=[np.zeros((0, 6))], masks=[None], names={}).ims is ims
    t = torch.ones(2)
    assert replicate(tree=t, mesh=make_mesh(device="cpu")) is t
    save_checkpoint(tmp_path / "c.pt", state_dict={"epoch": 3})
    assert load_checkpoint(tmp_path / "c.pt")["epoch"] == 3
