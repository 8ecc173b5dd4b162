"""The 17 configs of the detect zoo's new modules as whole narrow models (every
width_multiple divided down to 1/16, so each row keeps at least 8 channels),
64 px, on the CPU: the port's fused raw head maps against JAX's fused ones
from the same seeded weights, within 1e-4 of each map's largest magnitude.
RFB's reference is JAX's unfused forward: JAX's fuse folds RFB's BasicConv
BatchNorms, which its BasicConv then still calls (the defect's own test is
below); the port's fuse folds Conv only, so its fused RFB is its unfused one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT, random_variables
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.nn.common import Conv
from yolo_dual_tpu_torch.nn.spp import BasicConv

JAX_CFG = ROOT / "yolo_dual_tpu" / "configs"
SLICE = sorted([f"spp/{p.stem}" for p in JAX_CFG.glob("spp/*.yaml")]
               + [f"attention/{p.stem}" for p in JAX_CFG.glob("attention/*.yaml")]
               + ["hub/yolov3-spp", "hub/yolov3-tiny", "hub/yolov5s-ghost",
                  "hub/yolov5s-transformer"])
RFB = "spp/yolov5n-RFB"
IMGSZ = 64


def narrow(name):
    d = yaml.safe_load((JAX_CFG / f"{name}.yaml").read_text())
    d["width_multiple"] = 1 / 16
    return d


@functools.lru_cache(maxsize=None)
def jax_model(name, seed):
    d = narrow(name)
    jm = jax_build_model(d)
    return d, jm, random_variables(lambda k, x: jm.module.init(k, x, train=False),
                                   (1, IMGSZ, IMGSZ, 3), seed=seed)


def jax_and_port(name, seed):
    """JAX's model of the narrow config, seeded variables, and the port's
    model on the CPU with those weights."""
    d, jm, v = jax_model(name, seed)
    port = build_model(d, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    return jm, v, port.eval()


def frames(seed):
    return np.random.default_rng(seed).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)


@pytest.mark.parametrize("name", SLICE)
def test_fused_head_maps_match_jax(name):
    jm, v, port = jax_and_port(name, seed=len(name))
    x = frames(1)
    m, mv = (jm, v) if name == RFB else jm.fuse(v)
    want = jax.jit(lambda v, x: m.apply(v, x, train=False, decode=False))(mv, jnp.asarray(x))
    with torch.no_grad():
        got = port.fuse()(torch.from_numpy(x).permute(0, 3, 1, 2), decode=False)
    assert len(got) == len(want) == len(port.model[-1].strides)
    assert all(c.bn is None for c in port.modules() if isinstance(c, Conv))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_jax_fuse_breaks_rfb_and_the_port_fuses_it_to_its_eval_forward():
    """JAX's fuse_conv_bn folds every sibling conv + bn pair, RFB's BasicConvs
    included, but BasicConv calls its BatchNorm fused or not: the fused apply
    raises, so JAX's AutoShape (fuse=True) cannot serve the RFB config. If the
    JAX package is fixed, the first half fails. The port folds Conv only: its
    fused RFB model keeps every BasicConv BatchNorm and gives its unfused
    eval forward."""
    jm, v, port = jax_and_port(RFB, seed=len(RFB))
    x = frames(2)
    fm, fv = jm.fuse(v)
    with pytest.raises(Exception, match="batch_stats|bn"):
        fm.apply(fv, jnp.asarray(x), train=False, decode=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        unfused = [t.clone() for t in port(xt, decode=False)]
        fused = port.fuse()(xt, decode=False)
    basic = [m for m in port.modules() if isinstance(m, BasicConv)]
    assert len(basic) == 12 and all(m.bn is not None for m in basic)
    for a, b in zip(fused, unfused):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * b.abs().max().item())
