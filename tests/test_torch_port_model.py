"""The port's modules, compiler, weight carrier and whole model against the
JAX package, on the same seeded weights.

Weights cross over through yolo_dual_tpu_torch/io/weights.py:state_dict_from_flax
into `load_state_dict(strict=True)`. Tolerance: atol 1e-4 and rtol 1e-4 in
float32, because the two frameworks sum the convolutions in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import SEG_CFG, nhwc, random_variables
from yolo_dual_tpu.models.compiler import parse_config as jax_parse_config
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.nn import common as JC
from yolo_dual_tpu.utils.general import yaml_load
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.compiler import parse_config
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.nn import common as PC
from yolo_dual_tpu_torch.utils.general import load_config

TOL = dict(rtol=1e-4, atol=1e-4)

MODULES = {  # name: (flax module, port module, NHWC input shape)
    "Conv": (lambda: JC.Conv(8, 3, 2), lambda: PC.Conv(4, 8, 3, 2), (2, 12, 12, 4)),
    "Conv_stem_k6s2p2": (lambda: JC.Conv(8, 6, 2, 2), lambda: PC.Conv(3, 8, 6, 2, 2), (1, 16, 16, 3)),
    "Bottleneck": (lambda: JC.Bottleneck(8), lambda: PC.Bottleneck(8, 8), (1, 8, 8, 8)),
    "C3": (lambda: JC.C3(16, n=2), lambda: PC.C3(8, 16, n=2), (2, 8, 8, 8)),
    "C3_no_shortcut": (lambda: JC.C3(8, n=1, shortcut=False), lambda: PC.C3(8, 8, 1, False), (1, 8, 8, 8)),
    "SPPF": (lambda: JC.SPPF(16, 5), lambda: PC.SPPF(16, 16, 5), (1, 8, 8, 16)),
    "Proto": (lambda: JC.Proto(16, 8), lambda: PC.Proto(8, 16, 8), (1, 4, 4, 8)),
    "Upsample": (lambda: JC.Upsample(None, 2, "nearest"), lambda: PC.Upsample(None, 2, "nearest"),
                 (1, 4, 4, 8)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    make_jax, make_port, shape = MODULES[name]
    jm = make_jax()
    v = random_variables(lambda k, x: jm.init(k, x, train=False), shape, seed=len(name))
    x = np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    pm = make_port().eval()
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_state_dict_from_flax_transposes_dense_kernels():
    """A flax Dense kernel (in, out) becomes an nn.Linear weight (out, in)."""
    import flax.linen as fnn
    jm = fnn.Dense(5)
    v = random_variables(lambda k, x: jm.init(k, x), (2, 3, 4, 3), seed=3)
    x = np.random.default_rng(4).normal(0, 1, (2, 3, 4, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = torch.nn.Linear(3, 5)
    pm.load_state_dict(state_dict_from_flax(v), strict=True)
    np.testing.assert_array_equal(pm.weight.detach().numpy(), v["params"]["kernel"].T)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", "nsmlx")
def test_compiler_matches_jax(size):
    cfg = f"yolov5{size}-seg"
    d = load_config(SEG_CFG.parents[2] / "yolo_dual_tpu_torch" / "configs" / "segment" / f"{cfg}.json")
    port, ref = parse_config(d), jax_parse_config(yaml_load(SEG_CFG / f"{cfg}.yaml"))
    assert len(port.layers) == len(ref.layers)
    for p, r in zip(port.layers, ref.layers):
        assert (p.i, p.f, p.n, p.name, p.c2, p.kw()) == (r.i, r.f, r.n, r.name, r.c2, r.kw())
    assert (port.save, port.out_ch, port.anchors, port.nc) == (ref.save, ref.out_ch, ref.anchors, ref.nc)
    if size == "s":
        assert port.layers[-1].kw()["npr"] == 128


def test_full_width_state_dict_matches_flax_tree():
    """yolov5s-seg at full width: every port parameter and buffer has a
    counterpart of the same shape in the JAX variable tree, and back."""
    jm = JaxSegmentationModel(SEG_CFG / "yolov5s-seg.yaml")
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros)
    port = SegmentationModel("yolov5s-seg.json", device="cpu")
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert port.spec.strides == jm.spec.strides == (8, 16, 32)
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.fixture(scope="module")
def nano():
    """yolov5n-seg at 64 px on seeded weights: the JAX model, its variables,
    an input batch and the JAX outputs, unfused and fused (blocked=False)."""
    jm = JaxSegmentationModel(SEG_CFG / "yolov5n-seg.yaml")
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=0)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = jm.apply(v, jnp.asarray(x), train=False)
    fm, fv = jm.fuse(v, blocked=False)
    fout = fm.apply(fv, jnp.asarray(x), train=False)
    to_np = lambda o: (np.asarray(o[0]), np.asarray(o[1]), [np.asarray(r) for r in o[2]])  # noqa: E731
    return {"v": v, "fv": jax.tree_util.tree_map(np.asarray, fv), "x": x,
            "out": to_np(out), "fout": to_np(fout)}


def _port_outputs(model, x):
    with torch.no_grad():
        pred, protos, raw = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return pred.numpy(), nhwc(protos), [r.numpy() for r in raw]


def _assert_outputs_close(got, want):
    pred, protos, raw = got
    np.testing.assert_allclose(pred, want[0], **TOL)
    np.testing.assert_allclose(protos, want[1], **TOL)
    assert len(raw) == len(want[2]) == 3
    for r, w in zip(raw, want[2]):
        assert r.shape == w.shape  # (bs, na, ny, nx, no) in both
        np.testing.assert_allclose(r, w, **TOL)


def _port_nano(v):
    model = SegmentationModel("yolov5n-seg.json", device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    return model


def test_whole_model_unfused_matches_jax(nano):
    _assert_outputs_close(_port_outputs(_port_nano(nano["v"]), nano["x"]), nano["out"])


def test_whole_model_fused_matches_jax(nano):
    model = _port_nano(nano["v"]).fuse()
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    _assert_outputs_close(_port_outputs(model, nano["x"]), nano["fout"])


def test_jax_fused_variables_load_into_fused_port(nano):
    """The JAX fold and the port's fold produce the same parameters: JAX's
    fused variables load strictly into a fused port model and agree."""
    model = SegmentationModel("yolov5n-seg.json", device="cpu").fuse()
    model.load_state_dict(state_dict_from_flax(nano["fv"]), strict=True)
    _assert_outputs_close(_port_outputs(model, nano["x"]), nano["fout"])
