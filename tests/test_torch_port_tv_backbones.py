"""The port's torchvision-family stages (yolo_dual_tpu_torch/nn/torchvision_backbones.py)
against the JAX package's, family by family, on the same seeded weights
(torch_port_common.random_variables -> state_dict_from_flax).

Each family's three stages run in a chain, each stage on JAX's output of
the stage before, on a batch of 2 images (the odd size holds every stride-2
conv and pool's padding):
- eval mode at 64 and 65 px: the port's float32 forward within 1e-5 of the
  largest magnitude of JAX's float32 one;
- train mode at 65 px: tests/test_torch_port_tv_backbones_train.py.
STAGE_OUT holds each stage's width by jax.eval_shape at 224 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import nhwc, random_variables
from yolo_dual_tpu.nn import torchvision_backbones as JT
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.nn import torchvision_backbones as PT
from yolo_dual_tpu_torch.nn.spp import FixedProfileBatchNorm2d

FAMILIES = ("resnet18", "resnet34", "resnet50", "wide_resnet50_2", "MobileNetV3s",
            "mobilenet_v2", "efficientnet_b0", "efficientnet_b1", "efficientnet_v2_s",
            "RegNety400", "vgg11_bn", "convnext_tiny")
TOL = 1e-5  # of the largest magnitude (float32)
# the families' BatchNorm (eps, torch momentum): flax's 0.99 is torch's 0.01, 0.9 is 0.1
BN_PROFILE = {f: ((1e-3, 0.01) if f.startswith(("MobileNetV3", "efficientnet")) else (1e-5, 0.1))
              for f in FAMILIES}


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)


def assert_close(got, want, what, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert got.shape == want.shape and err <= tol, f"{what}: {err:.3g} of the largest magnitude"


def test_registry_names_the_36_stages():
    from yolo_dual_tpu_torch.models.compiler import REGISTRY, _populate_registry
    _populate_registry()
    assert set(PT.STAGE_OUT) == set(JT.STAGE_MODULES) and len(PT.STAGE_OUT) == 36
    assert set(PT.STAGE_OUT) <= set(REGISTRY)


@pytest.mark.parametrize("family", FAMILIES)
def test_stage_out_equals_jax_eval_shape(family):
    """STAGE_OUT and the stages' strides against jax.eval_shape of JAX's
    three stages at 224 px (no FLOPs)."""
    shape = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    sizes = []
    for i in (1, 2, 3):
        jm = JT.STAGE_MODULES[f"{family}{i}"](c2=0)
        shape = jax.eval_shape(lambda k, x: jm.init_with_output(k, x, train=False)[0],
                               jax.random.PRNGKey(0), shape)
        assert shape.shape[-1] == PT.STAGE_OUT[f"{family}{i}"]
        sizes.append(shape.shape[1])
    assert sizes == ([56, 28, 14] if family == "vgg11_bn" else [28, 14, 7])


def run_chain(family, x, jax_stage, port_stage):
    """Each of the family's stages on JAX's output of the one before: yields
    (name, JAX's output and batch statistics, the port's output and stage)."""
    c1 = 3
    for i in (1, 2, 3):
        name = f"{family}{i}"
        jm = JT.STAGE_MODULES[name](c2=0)
        v = random_variables(lambda k, xx: jm.init(k, xx, train=False), x.shape,
                             seed=len(name) + i)
        want, upd = jax_stage(jm, v, x)
        port = PT.build_stage(name, c1, PT.STAGE_OUT[name])
        port.load_state_dict(state_dict_from_flax(v), strict=True)
        bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        assert bool(bns) != (family == "convnext_tiny")  # ConvNeXt's norms are LayerNorms
        assert all(isinstance(m, FixedProfileBatchNorm2d)
                   and (m.eps, m.momentum) == BN_PROFILE[family] for m in bns)
        got = port_stage(port, x)
        assert got.shape[-1] == PT.STAGE_OUT[name]
        yield name, want, upd, got, port
        x, c1 = want.astype(np.float32), got.shape[-1]


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("family", FAMILIES)
def test_stages_match_jax_eval(family, size):
    def jax_stage(jm, v, x):
        with jax.default_matmul_precision("highest"):
            return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)), None

    def port_stage(port, x):
        with torch.no_grad():
            return nhwc(port.eval()(to_nchw(x)))
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    for name, want, _, got, _ in run_chain(family, x, jax_stage, port_stage):
        assert_close(got, want, f"{name} output", TOL)
