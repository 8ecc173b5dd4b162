"""The detect zoo's modules, whole narrow models and the hub API of the port
against the JAX package on the CPU, from the same seeded weights
(torch_port_common.random_variables -> state_dict_from_flax).

Tolerances: a module's output and train-mode running statistics within rtol
and atol 1e-5 (float32). In eval mode the reference is JAX's float32 apply. In
train mode it is JAX's apply in float64 (`jax_train_float64`): flax takes the
batch variance as E[x²] − E[x]² in float32, which where a channel's mean is
~10x its spread (a conv over max pools) is itself ~1e-5 relative off the
exact value, so the port's float32 run is held to JAX's exact one. A whole
narrow model's fused raw head maps within
1e-4 of each map's largest magnitude; AutoShape's detections the same count
and classes, boxes within 1e-3 px and confidences within 1e-5, rows within
1e-4 of the threshold or of another row's confidence (near ties) counted and
left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import ROOT, jax_train_float64, nhwc, random_variables
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu.nn import attention as JA
from yolo_dual_tpu.nn import backbones as JB
from yolo_dual_tpu.nn import common as JC
from yolo_dual_tpu.nn import spp as JS
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.nn import attention as PA
from yolo_dual_tpu_torch.nn import backbones as PB
from yolo_dual_tpu_torch.nn import common as PC
from yolo_dual_tpu_torch.nn import spp as PS

JAX_CFG = ROOT / "yolo_dual_tpu" / "configs"
TOL = dict(rtol=1e-5, atol=1e-5)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the modules, eval and train mode
# ---------------------------------------------------------------------------

MODULES = {  # name: (JAX module, port module, NHWC input shape)
    "SPP": (lambda: JC.SPP(16, (5, 9, 13)), lambda: PC.SPP(12, 16, (5, 9, 13)), (2, 9, 10, 12)),
    "GhostConv": (lambda: JC.GhostConv(16, 3, 2), lambda: PC.GhostConv(8, 16, 3, 2), (2, 9, 10, 8)),
    "GhostBottleneck_s1": (lambda: JC.GhostBottleneck(16), lambda: PC.GhostBottleneck(16, 16),
                           (2, 8, 9, 16)),
    "GhostBottleneck_s2": (lambda: JC.GhostBottleneck(16, 3, 2),
                           lambda: PC.GhostBottleneck(8, 16, 3, 2), (2, 9, 10, 8)),
    "C3Ghost": (lambda: JC.C3Ghost(16, n=2), lambda: PC.C3Ghost(8, 16, n=2), (2, 8, 9, 8)),
    "C3TR": (lambda: JC.C3TR(32, n=2), lambda: PC.C3TR(16, 32, n=2), (2, 5, 6, 16)),
    "TransformerBlock_conv": (lambda: JC.TransformerBlock(16, 4, 1),
                              lambda: PC.TransformerBlock(8, 16, 4, 1), (2, 4, 5, 8)),
    "ZeroPad2d": (lambda: JC.ZeroPad2d((0, 1, 2, 3)), lambda: PC.ZeroPad2d((0, 1, 2, 3)),
                  (2, 5, 6, 3)),
    "MaxPool2d_k3s2p1": (lambda: JB.MaxPool2d(3, 2, 1), lambda: PB.MaxPool2d(3, 2, 1),
                         (2, 9, 10, 3)),
    "SimConv": (lambda: JS.SimConv(16, 3, 2), lambda: PS.SimConv(8, 16, 3, 2), (2, 9, 10, 8)),
    "SimSPPF": (lambda: JS.SimSPPF(16, 5), lambda: PS.SimSPPF(12, 16, 5), (2, 9, 10, 12)),
    "ASPP": (lambda: JS.ASPP(8), lambda: PS.ASPP(6, 8), (2, 9, 10, 6)),
    "BasicConv": (lambda: JS.BasicConv(8, 3, 1, 1), lambda: PS.BasicConv(6, 8, 3, 1, 1),
                  (2, 9, 10, 6)),
    "BasicConv_no_relu_d2_g2": (lambda: JS.BasicConv(8, 3, 2, 2, d=2, g=2, relu=False),
                                lambda: PS.BasicConv(6, 8, 3, 2, 2, d=2, g=2, relu=False),
                                (2, 9, 10, 6)),
    "BasicConv_no_bn": (lambda: JS.BasicConv(8, 3, 1, 1, bn=False),
                        lambda: PS.BasicConv(6, 8, 3, 1, 1, bn=False), (2, 9, 10, 6)),
    "BasicConv_no_bn_no_relu": (lambda: JS.BasicConv(8, 1, relu=False, bn=False),
                                lambda: PS.BasicConv(6, 8, 1, relu=False, bn=False),
                                (2, 9, 10, 6)),
    "RFB": (lambda: JS.RFB(16), lambda: PS.RFB(32, 16), (2, 9, 10, 32)),
    "RFB_s2_vision2": (lambda: JS.RFB(16, stride=2, vision=2), lambda: PS.RFB(32, 16, 2, vision=2),
                       (2, 11, 10, 32)),
    "SPPCSPC": (lambda: JS.SPPCSPC(8), lambda: PS.SPPCSPC(12, 8), (2, 9, 10, 12)),
    "SPPCSPC_group": (lambda: JS.SPPCSPC_group(8), lambda: PS.SPPCSPC_group(12, 8),
                      (2, 9, 10, 12)),
    "SimCSPSPPF": (lambda: JS.SimCSPSPPF(8), lambda: PS.SimCSPSPPF(12, 8), (2, 9, 10, 12)),
    "AttentionConv": (lambda: JA.AttentionConv(8, 3, 1, 1), lambda: PA.AttentionConv(6, 8, 3, 1, 1),
                      (2, 9, 10, 6)),
    "AttentionConv_s2": (lambda: JA.AttentionConv(8, 3, 2, 1),
                         lambda: PA.AttentionConv(6, 8, 3, 2, 1), (2, 9, 10, 6)),
    "AttentionConv_p0": (lambda: JA.AttentionConv(8, 3, 1, 0),
                         lambda: PA.AttentionConv(6, 8, 3, 1, 0), (2, 9, 10, 6)),
    "AttentionStem": (lambda: JA.AttentionStem(8, 3, 1, 1), lambda: PA.AttentionStem(6, 8, 3, 1, 1),
                      (2, 9, 10, 6)),
    "AttentionStem_p0_g2": (lambda: JA.AttentionStem(8, 3, 1, 0, 2),
                            lambda: PA.AttentionStem(6, 8, 3, 1, 0, 2), (2, 9, 10, 6)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train):
    """Outputs, and in train mode every BatchNorm's updated running statistics
    (BasicConv's under its own eps 1e-5 and momentum 0.01)."""
    jmod, pmod, shape = MODULES[name]
    jm = jmod()
    v = random_variables(lambda k, x: jm.init(k, x, train=False), shape, seed=len(name))
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    if train:
        want, upd = jax_train_float64(jm, v, x)
    else:
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    port = pmod()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port.train(train)
    with torch.no_grad():
        got = nhwc(port(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL, err_msg="output")
    if train:
        sd = port.state_dict()
        for k, w in state_dict_from_flax({"batch_stats": upd}).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_basic_conv_keeps_its_own_batchnorm_profile_in_a_graph():
    """RFB's BasicConv BatchNorms keep eps 1e-5 / momentum 0.01 inside a detect
    graph, whose other BatchNorms take eps 1e-3 / momentum 0.03."""
    model = build_model("yolov5n-RFB.json", device="cpu")
    profiles = {(type(m).__name__, m.eps, m.momentum) for m in model.modules()
                if isinstance(m, torch.nn.BatchNorm2d)}
    assert profiles == {("BatchNorm2d", 1e-3, 0.03), ("FixedProfileBatchNorm2d", 1e-5, 0.01)}


# ---------------------------------------------------------------------------
# the reference's joint attention projections in `.pt` files
# ---------------------------------------------------------------------------


def test_pt_with_joint_in_proj_loads_strict_and_gives_jax_output(tmp_path):
    """A reference-style state_dict of narrow yolov5s-transformer (C3TR's
    block `m`, each TransformerLayer's nn.MultiheadAttention `ma` with its
    joint in_proj_weight / in_proj_bias and out_proj) and JAX's own export of
    the same weights (`m_tr`, split projections) both load strictly through
    the port's `.pt` path, and the port then gives JAX's raw head maps on
    those weights within 1e-4 of each map's largest magnitude. JAX's torch
    import cannot read the reference layout strictly (it keeps the `ma`
    level and looks for C3TR's block under `m`, where its tree says `m_tr`):
    if the JAX package is fixed, the last check fails."""
    import re

    from yolo_dual_tpu.io.torch_import import import_torch_state_dict
    from yolo_dual_tpu.train.checkpoint import export_torch_state_dict
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file
    d = yaml.safe_load((JAX_CFG / "hub" / "yolov5s-transformer.yaml").read_text())
    d["width_multiple"] = 1 / 16
    jm = jax_build_model(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=4)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False, decode=False))(v, jnp.asarray(x))
    ref, proj = {}, {}
    for k, t in state_dict_from_flax(v).items():
        m = re.fullmatch(r"(.*\.tr\.\d+\.)(in_q|in_k|in_v|out_proj)\.(weight|bias)", k)
        if m:
            proj.setdefault(m.group(1), {})[(m.group(2), m.group(3))] = t
        else:
            ref[k] = t
    assert len(proj) == 1  # one C3TR row, n = 1 layer
    for layer, p in proj.items():
        for leaf in ("weight", "bias"):
            ref[f"{layer}ma.in_proj_{leaf}"] = torch.cat([p[(n, leaf)] for n in ("in_q", "in_k",
                                                                                  "in_v")])
            ref[f"{layer}ma.out_proj.{leaf}"] = p[("out_proj", leaf)]
    torch.save({"model": ref}, tmp_path / "reference.pt")
    exported = {k: torch.from_numpy(np.array(t))
                for k, t in export_torch_state_dict(v, jm.spec).items()}
    assert any(".m_tr." in k for k in exported)
    torch.save(exported, tmp_path / "jax_export.pt")
    for f in ("reference.pt", "jax_export.pt"):
        port = build_model(d, device="cpu")
        port.load_state_dict(load_state_dict_file(tmp_path / f), strict=True)
        with torch.no_grad():
            got = port.eval()(to_nchw(x), decode=False)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f)
    with pytest.raises(ValueError, match="strict torch import failed"):
        import_torch_state_dict(v, {k: t.numpy() for k, t in ref.items()}, spec=jm.spec,
                                strict=True)
