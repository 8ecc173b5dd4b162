"""A `.pt` file that fills only part of a model loads as JAX's `.pt` route
loads it (JAX io/weights.py:12 resolve_variables: a fresh `model.init()`,
PRNGKey(0) and the Detect bias prior, filled by `import_torch_state_dict(...,
strict=False)`).

The file: a reference-layout state_dict (tests/reference_layout.py) of a
narrow yolov5s-seg-dcnv3 (width 1/8, nc 3, seeded variables, its Detect
biases primed so that it keeps boxes), with one conv's weight dropped and a
key that matches no entry added. Through the port's `resolve_state_dict`
every entry equals JAX's resolved variables (the file's where it has them,
JAX's fresh init in the dropped conv and the DCNv3 offset and mask heads'
init, to 1e-6: the init's inverse error function is XLA's float32 one,
models/flax_init.py); `segment.val` on the file gives JAX's
`load_model_and_weights` + `evaluate_segment` metrics within 1e-4, and
MultiBackend JAX's MultiBackend outputs within 1e-4. A file that matches
nothing raises in both packages.

JAX's eager `model.init()` of this graph takes ~40 s on the CPU; the test
runs the same init jitted (the same draws).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from reference_layout import reference_state_dict
from test_torch_port_data import H0, W0, loaders, write_dataset
from test_torch_port_serve import jax_serve_module
from torch_port_common import IMGSZ, random_variables
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu.io.multibackend import MultiBackend as JaxMultiBackend
from yolo_dual_tpu.io.weights import resolve_variables
from yolo_dual_tpu.models import model as jax_model
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu_torch.io.multibackend import MultiBackend
from yolo_dual_tpu_torch.io.weights import resolve_state_dict, state_dict_from_flax
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.segment import val as val_cli
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

NC = 3
DROPPED = "model.2.cv1.conv.weight"
EXTRA = "model.2.cv9.conv.weight"
INIT_TOL = 1e-6


def narrow_dcnv3():
    d = load_config(find_cfg("yolov5s-seg-dcnv3.json"))
    return {**d, "nc": NC, "width_multiple": 0.125}


_INITS = {}


def jit_init(self, rng=None, imgsz=640, bias_prior=True):
    """JAX's BaseModel.init (PRNGKey(0)) with the module's init jitted: the
    same draws, without the eager init's ~40 s; each config's drawn once
    and handed out as copies."""
    assert rng is None
    key = (json.dumps(self.yaml, sort_keys=True), imgsz, bias_prior)
    if key not in _INITS:
        x = jnp.zeros((1, imgsz, imgsz, self.spec.ch_in), jnp.float32)
        variables = jax.jit(lambda r, x: self.module.init(r, x, train=True))(
            jax.random.PRNGKey(0), x)
        variables = jax_model._to_mutable(jax.tree_util.tree_map(np.asarray, variables))
        if bias_prior and self.spec.layers[-1].name in ("Detect", "Segment", "DetectAux"):
            variables = jax_model.initialize_detect_biases(variables, self.spec)
        _INITS[key] = variables
    return jax.tree_util.tree_map(np.copy, _INITS[key])


@pytest.fixture(scope="module")
def partial_file(tmp_path_factory):
    """(config, the `.pt` path, JAX's resolved variables, the config's yaml
    and json paths)."""
    tmp = tmp_path_factory.mktemp("partial")
    d = narrow_dcnv3()
    jm = JaxSegmentationModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=12)
    head = v["params"][f"model_{jm.spec.layers[-1].i}"]["detect"]
    for li in range(3):  # primed as torch_port_common.primed_tiny primes TINY_SEG
        b = head[f"m_{li}"]["bias"].reshape(3, -1)
        b[:, 4] += 3.0
        b[:, 5:5 + NC] += 1.0
    port = SegmentationModel(d, device="cpu")
    sd = reference_state_dict(state_dict_from_flax(v), port.spec, semantic_roots=False)
    assert DROPPED in sd and EXTRA not in sd
    del sd[DROPPED]
    sd[EXTRA] = torch.ones(4, 4, 1, 1)
    path = tmp / "partial.pt"
    torch.save({"model": sd, "epoch": 3}, path)
    (tmp / "cfg.yaml").write_text(yaml.safe_dump(d))
    (tmp / "cfg.json").write_text(json.dumps(d))
    fresh = jit_init(jm, imgsz=IMGSZ)
    resolved = resolve_variables(jm, path, jit_init(jm, imgsz=IMGSZ))
    return d, path, resolved, fresh, tmp


def test_resolved_entries_equal_jax_fill_of_a_fresh_init(partial_file):
    d, path, resolved, fresh, _ = partial_file
    port = SegmentationModel(d, device="cpu")
    got = resolve_state_dict(path, port)
    want = state_dict_from_flax(resolved)
    init = state_dict_from_flax(fresh)
    assert set(got) == set(port.state_dict())
    for k, w in want.items():
        assert torch.allclose(got[k], w, rtol=0, atol=INIT_TOL), k
    # the unfilled entries hold JAX's fresh init, not the port's seeded one or the file's
    assert torch.allclose(got[DROPPED], init[DROPPED], rtol=0, atol=INIT_TOL)
    assert not torch.allclose(port.state_dict()[DROPPED], init[DROPPED], atol=1e-3)
    # flax_init_ draws JAX's init of every entry, DCNv3's zero offset and mask heads too
    whole = flax_init_(SegmentationModel(d, device="cpu"), 0).state_dict()
    heads = [k for k in init if ".dcnv3.offset." in k or ".dcnv3.mask." in k]
    assert heads and all(not init[k].any() for k in heads)
    for k, w in init.items():
        assert torch.allclose(whole[k], w, rtol=0, atol=INIT_TOL), k


def test_segment_val_and_multibackend_equal_jax_on_a_partial_file(partial_file, monkeypatch):
    d, path, resolved, _, tmp = partial_file
    root = write_dataset(tmp / "data", n=5)
    model = SegmentationModel(d, device="cpu")
    model.load_state_dict(resolve_state_dict(path, model), strict=True)
    model.eval()
    head = model.model[-1]
    for f in sorted((root / "port" / "images").glob("*.npy")):  # labels: the model's own boxes
        x = letterbox_normalize(torch.from_numpy(np.load(f))[None], IMGSZ, scaleup=False)
        with torch.no_grad():
            out, nv = nms_from_raw(model(x, decode=False)[0], head.anchors, head.strides,
                                   conf_thres=1e-4, iou_thres=0.6, max_det=20, nm=head.nm)
        lines = []
        for r in out[0, :int(nv[0])].numpy()[:4]:
            x1, x2 = np.clip(np.round(r[[0, 2]]), 0, IMGSZ) / W0
            y1, y2 = (np.clip(np.round(r[[1, 3]]), 8, 56) - 8) / H0
            if x2 - x1 > 2 / W0 and y2 - y1 > 2 / H0:
                lines.append(f"{int(r[5])} {x1} {y1} {x2} {y1} {x2} {y2} {x1} {y2}")
        for side in ("jax", "port"):
            (root / side / "labels" / f"{f.stem}.txt").write_text("\n".join(lines))

    jax_serve_module()  # loads JAX's segment/val.py as jax_segment_val_vs_port
    import sys
    jval = sys.modules["jax_segment_val_vs_port"]
    monkeypatch.setattr(jax_model.BaseModel, "init", jit_init)
    jm, jv = jval.load_model_and_weights(str(path), str(tmp / "cfg.yaml"), NC, IMGSZ)
    jl, _ = loaders(root, bs=2)
    want, want_maps, _ = jax_evaluate_segment(jm, jv, jl, NC, conf_thres=0.001, iou_thres=0.6,
                                              nm=head.nm)
    got, got_maps, _ = val_cli.run(data=str(root / "port"), weights=str(path),
                                   cfg=str(tmp / "cfg.json"), batch_size=2, imgsz=IMGSZ,
                                   device="cpu", device_preprocess=True)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05, got

    x = np.random.default_rng(1).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jmb = JaxMultiBackend(path, cfg=d, nc=NC, imgsz=IMGSZ)
    with jax.default_matmul_precision("highest"):
        jpred, jprotos = jmb._fwd(jmb.variables, jnp.asarray(x))
    mb = MultiBackend(path, cfg=d, nc=NC, imgsz=IMGSZ, device="cpu")
    pred, protos = mb(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in ((pred.numpy(), np.asarray(jpred)),
                 (protos.permute(0, 2, 3, 1).numpy(), np.asarray(jprotos))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())))


def test_a_file_that_matches_nothing_raises_in_both(partial_file, tmp_path):
    d = partial_file[0]
    path = tmp_path / "foreign.pt"
    torch.save({"encoder.0.weight": torch.ones(3, 3), "decoder.bias": torch.ones(3)}, path)
    with pytest.raises(ValueError, match="matched 0"):
        resolve_state_dict(path, SegmentationModel(d, device="cpu"))
    jm = JaxSegmentationModel(d)
    with pytest.raises(ValueError, match="matched 0"):
        resolve_variables(jm, path, jit_init(jm, imgsz=IMGSZ))
