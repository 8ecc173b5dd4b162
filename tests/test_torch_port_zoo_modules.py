"""The registry names no shipped config uses (ROADMAP 6d) and the AuxOTA head
against the JAX package on the CPU, from the same seeded weights
(torch_port_common.random_variables -> state_dict_from_flax):

- each module in eval mode against JAX's float32 apply and in train mode
  against JAX's apply in float64 (`jax_train_float64`), outputs and updated
  running statistics within rtol and atol 1e-5: DWConv, Focus, CrossConv,
  BottleneckCSP, C3x, C3SPP, MixConv2d (both channel splits), the transposed
  convs, Contract, Expand, Sum, the standalone BatchNorm, Upsample in every
  mode, DetectAux, and FReLU, AconC and MetaAconC (built directly, as JAX's);
- the transposed conv's weight carried as it is (lax flips it), and the
  half-pixel nearest resize that JAX's Upsample takes at a non-integer factor;
- the port's registry equals JAX's, every one of JAX's 63 model configs
  builds, and chip_smoke.py's 6d graph (every new name, DetectAux head) has
  JAX's tree, loads it strictly, gives JAX's raw maps and decoded output in
  eval and its raw maps in train mode within 1e-5 of each map's largest,
  and `flax_init_` gives it JAX's initial weights within 8 float32 ulps;
- fuse() leaves BottleneckCSP's BatchNorm, as JAX's fuse does.

JAX's ConvTranspose (nn.ConvTranspose2d, DWConvTranspose2d) hands flax's
nn.ConvTranspose a feature_group_count, which flax 0.12 does not take, so
JAX's own module raises TypeError (ROADMAP §C). Its compiler always passes
g = 1, so the tests hold the port against `JaxConvTranspose`, JAX's module
with that argument left out, registered in its place for this file's graphs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import flax.linen as fnn

import chip_smoke
from torch_port_common import ROOT, jax_train_float64, nhwc, random_variables
from yolo_dual_tpu.models import compiler as jax_compiler
from yolo_dual_tpu.models import heads as JH
from yolo_dual_tpu.models.model import GraphModel as JaxGraphModel
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu.models.model import _to_mutable as jax_to_mutable
from yolo_dual_tpu.models.model import fuse_conv_bn as jax_fuse_conv_bn
from yolo_dual_tpu.models.model import initialize_detect_biases as jax_initialize_detect_biases
from yolo_dual_tpu.nn import act_modules as JAM
from yolo_dual_tpu.nn import common as JC
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models import compiler as port_compiler
from yolo_dual_tpu_torch.models import heads as PH
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import GraphModel, _probe_strides, build_model
from yolo_dual_tpu_torch.nn import act_modules as PAM
from yolo_dual_tpu_torch.nn import common as PC

JAX_CFG = ROOT / "yolo_dual_tpu" / "configs"
TOL = dict(rtol=1e-5, atol=1e-5)
ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
# JAX's model configs: every yaml but the data and hyperparameter files and hub/anchors.yaml
MODEL_CFGS = sorted(str(p.relative_to(JAX_CFG).with_suffix("")) for p in JAX_CFG.glob("*/*.yaml")
                    if p.parent.name not in ("data", "hyps") and p.stem != "anchors")


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


class JaxConvTranspose(JC.ConvTranspose):
    """JAX nn/common.py:ConvTranspose without feature_group_count (g is 1)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        assert self.g == 1
        pad = self.k - 1 - self.p
        return fnn.ConvTranspose(features=self.c2, kernel_size=(self.k, self.k),
                                 strides=(self.s, self.s), padding=((pad, pad), (pad, pad)),
                                 use_bias=self.bias, transpose_kernel=True, dtype=self.dtype,
                                 name="conv")(x)


@pytest.fixture(scope="module", autouse=True)
def jax_conv_transpose():
    """JaxConvTranspose in JAX's registry while this file runs."""
    jax_compiler._populate_registry()

    def build(kwargs, dtype=None, name=None, remat=False):
        return JaxConvTranspose(**kwargs, dtype=dtype, name=name)
    with pytest.MonkeyPatch.context() as mp:
        for nm in ("nn.ConvTranspose2d", "DWConvTranspose2d"):
            mp.setitem(jax_compiler.REGISTRY, nm, build)
        yield


def test_jax_conv_transpose_passes_what_flax_refuses():
    """JAX's own module raises on flax 0.12; if the JAX package is fixed or
    flax takes the argument again, this fails and JaxConvTranspose can go."""
    with pytest.raises(TypeError, match="feature_group_count"):
        JC.ConvTranspose(8).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))


def nhwc_params(sd):
    """The activations' NHWC (1, 1, 1, c) p1, p2, beta as the port's (1, c, 1, 1)."""
    return {k: v.permute(0, 3, 1, 2) if k.rsplit(".", 1)[-1] in ("p1", "p2", "beta") else v
            for k, v in sd.items()}


MODULES = {  # name: (JAX module, port module, NHWC input shape, or a list of them)
    "DWConv": (lambda: JC.DWConv(16, 3, 2), lambda: PC.DWConv(8, 16, 3, 2), (2, 9, 10, 8)),
    "Focus": (lambda: JC.Focus(16, 3), lambda: PC.Focus(3, 16, 3), (2, 10, 12, 3)),
    "Focus_s2": (lambda: JC.Focus(8, 1, 2), lambda: PC.Focus(3, 8, 1, 2), (2, 10, 14, 3)),
    "CrossConv": (lambda: JC.CrossConv(16, 3, 1, 1, 1.0, True),
                  lambda: PC.CrossConv(16, 16, 3, 1, 1, 1.0, True), (2, 9, 10, 16)),
    "CrossConv_s2_e05": (lambda: JC.CrossConv(16, 5, 2, 1, 0.5),
                         lambda: PC.CrossConv(8, 16, 5, 2, 1, 0.5), (2, 9, 10, 8)),
    "BottleneckCSP": (lambda: JC.BottleneckCSP(16, n=2), lambda: PC.BottleneckCSP(8, 16, 2),
                      (2, 8, 9, 8)),
    "BottleneckCSP_no_shortcut": (lambda: JC.BottleneckCSP(16, 1, False),
                                  lambda: PC.BottleneckCSP(16, 16, 1, False), (2, 8, 9, 16)),
    "C3x": (lambda: JC.C3x(16, n=2), lambda: PC.C3x(8, 16, n=2), (2, 8, 9, 8)),
    "C3SPP": (lambda: JC.C3SPP(16, k=(3, 5)), lambda: PC.C3SPP(8, 16, k=(3, 5)), (2, 8, 9, 8)),
    "MixConv2d_equal": (lambda: JC.MixConv2d(16, (1, 3, 5)), lambda: PC.MixConv2d(8, 16, (1, 3, 5)),
                        (2, 8, 9, 8)),
    # shares 1/k²: 13, 2, 1 and 0 channels, so the k=7 branch (JAX's m_3) is left out
    "MixConv2d_area_s2": (lambda: JC.MixConv2d(16, (1, 3, 5, 7), 2, False),
                          lambda: PC.MixConv2d(8, 16, (1, 3, 5, 7), 2, False), (2, 9, 10, 8)),
    "ConvTranspose_k2s2": (lambda: JaxConvTranspose(8), lambda: PC.ConvTranspose(6, 8),
                           (2, 5, 6, 6)),
    "ConvTranspose_k4s2p1": (lambda: JaxConvTranspose(8, 4, 2, 1),
                             lambda: PC.ConvTranspose(6, 8, 4, 2, 1), (2, 5, 6, 6)),
    "DWConvTranspose2d_k3s1p1": (lambda: JaxConvTranspose(8, 3, 1, 1),
                                 lambda: PC.DWConvTranspose2d(6, 8, 3, 1, 1), (2, 5, 6, 6)),
    "Contract": (lambda: JC.Contract(2), lambda: PC.Contract(2), (2, 8, 10, 3)),
    "Expand": (lambda: JC.Expand(2), lambda: PC.Expand(2), (2, 4, 5, 12)),
    "Sum": (lambda: JC.Sum(3), lambda: PC.Sum(3), [(2, 5, 6, 4)] * 3),
    "Sum_weighted": (lambda: JC.Sum(3, True), lambda: PC.Sum(3, True), [(2, 5, 6, 4)] * 3),
    "BatchNorm2d": (lambda: JC.BatchNorm2d(), lambda: PC.BatchNormLayer(6), (2, 5, 6, 6)),
    "Upsample_nearest_x2": (lambda: JC.Upsample(None, 2, "nearest"),
                            lambda: PC.Upsample(None, 2, "nearest"), (2, 5, 6, 3)),
    "Upsample_nearest_x1.5": (lambda: JC.Upsample(None, 1.5, "nearest"),
                              lambda: PC.Upsample(None, 1.5, "nearest"), (2, 5, 6, 3)),
    "Upsample_nearest_x0.5": (lambda: JC.Upsample(None, 0.5, "nearest"),
                              lambda: PC.Upsample(None, 0.5, "nearest"), (2, 10, 13, 3)),
    "Upsample_nearest_size": (lambda: JC.Upsample((7, 4), None, "nearest"),
                              lambda: PC.Upsample((7, 4), None, "nearest"), (2, 5, 6, 3)),
    "Upsample_bilinear_x2": (lambda: JC.Upsample(None, 2, "bilinear"),
                             lambda: PC.Upsample(None, 2, "bilinear"), (2, 5, 6, 3)),
    "Upsample_bilinear_shrink": (lambda: JC.Upsample((4, 3), None, "bilinear"),
                                 lambda: PC.Upsample((4, 3), None, "bilinear"), (2, 9, 10, 3)),
    "Upsample_bicubic": (lambda: JC.Upsample(None, 3, "bicubic"),
                         lambda: PC.Upsample(None, 3, "bicubic"), (2, 5, 6, 3)),
    "FReLU": (lambda: JAM.FReLU(3), lambda: PAM.FReLU(6, 3), (2, 7, 8, 6)),
    "AconC": (lambda: JAM.AconC(), lambda: PAM.AconC(6), (2, 7, 8, 6)),
    "MetaAconC": (lambda: JAM.MetaAconC(4), lambda: PAM.MetaAconC(6, 4), (2, 7, 8, 6)),
    "DetectAux": (lambda: JH.DetectAux(3, ANCHORS, (8, 16, 32)),
                  lambda: PH.DetectAux(3, ANCHORS, (8, 16, 32), ch=(8, 12, 16, 4, 6, 8)),
                  [(2, 8, 8, 8), (2, 4, 4, 12), (2, 2, 2, 16), (2, 8, 8, 4), (2, 4, 4, 6),
                   (2, 2, 2, 8)]),
}


def inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    if isinstance(shape, list):
        return [rng.standard_normal(s).astype(np.float32) for s in shape]
    return rng.standard_normal(shape).astype(np.float32)


def port_in(x):
    return [to_nchw(a) for a in x] if isinstance(x, list) else to_nchw(x)


def flat_out(out):
    """A module's output as a list of NHWC arrays (DetectAux's levels stay as they are)."""
    if isinstance(out, torch.Tensor):
        return [nhwc(out)] if out.ndim == 4 else [out.detach().numpy()]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in flat_out(o)]
    return [np.asarray(out)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train):
    """Outputs, and in train mode the updated running statistics."""
    jmod, pmod, shape = MODULES[name]
    jm = jmod()
    first = shape[0] if isinstance(shape, list) else shape
    x = inputs(shape)
    v = random_variables(lambda k, _: jm.init(k, [jnp.asarray(a) for a in x]
                                              if isinstance(x, list) else jnp.asarray(x),
                                              train=False), first, seed=len(name))
    if train:
        want, upd = jax_train_float64(jm, v, x)
    else:
        with jax.default_matmul_precision("highest"):
            want = jm.apply(v, [jnp.asarray(a) for a in x] if isinstance(x, list)
                            else jnp.asarray(x), train=False)
    port = pmod()
    port.load_state_dict(nhwc_params(state_dict_from_flax(v)), strict=True)
    port.train(train)
    with torch.no_grad():
        got = port(port_in(x), decode=not train) if name == "DetectAux" else port(port_in(x))
    got, want = flat_out(got), [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL, err_msg="output")
    if train:
        sd = port.state_dict()
        for k, w in state_dict_from_flax({"batch_stats": upd}).items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_conv_transpose_weight_carries_as_it_is():
    """JAX's ConvTranspose kernel (k, k, c2, c1) under transpose_kernel=True
    is torch's ConvTranspose2d weight (c1, c2, k, k) by the HWIO -> OIHW
    transpose alone: lax.conv_transpose flips the window itself. A spatially
    flipped copy gives another output."""
    jm = JaxConvTranspose(8, 3, 2, 1)
    x = inputs((2, 5, 6, 6))
    v = random_variables(lambda k, a: jm.init(k, a), x.shape, seed=2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    kernel = v["params"]["conv"]["kernel"]
    assert kernel.shape == (3, 3, 8, 6)
    port = PC.ConvTranspose(6, 8, 3, 2, 1)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    np.testing.assert_array_equal(port.conv.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(to_nchw(x))), want, **TOL)
        flipped = F.conv_transpose2d(to_nchw(x), port.conv.weight.flip(2, 3), port.conv.bias, 2, 1)
    assert np.abs(nhwc(flipped) - want).max() > 0.1


def test_nearest_at_a_non_integer_factor_takes_half_pixel_indices():
    """JAX's nearest resize reads input floor((i + 0.5)·n_in/n_out), not
    torch's floor(i·n_in/n_out) ("nearest"): at 5 -> 7 rows and 6 -> 9
    columns they differ, and the port takes JAX's."""
    x = inputs((1, 5, 6, 2))
    want = np.asarray(JC.resize_nearest(jnp.asarray(x), (7, 9)))
    got = nhwc(PC.resize_nearest(to_nchw(x), (7, 9)))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(nhwc(F.interpolate(to_nchw(x), size=(7, 9), mode="nearest")), want)


def test_registry_equals_jax():
    """The port registers JAX's 93 names: the 57 of the module zoo and the 36
    torchvision stages."""
    jax_compiler._populate_registry()
    port_compiler._populate_registry()
    assert set(port_compiler.REGISTRY) == set(jax_compiler.REGISTRY)
    assert len(port_compiler.REGISTRY) == 93


def test_model_configs_are_63():
    assert len(MODEL_CFGS) == 63 and "loss/yolov5n_auxota" in MODEL_CFGS


@pytest.mark.parametrize("cfg", MODEL_CFGS)
def test_model_config_builds(cfg):
    """Each of JAX's model configs compiles and builds in the port (on the
    meta device) with JAX's layer names, repeats and head strides."""
    d = yaml.safe_load((JAX_CFG / f"{cfg}.yaml").read_text())
    spec = port_compiler.parse_config(d)
    jspec = jax_compiler.parse_config(d)
    assert [(la.name, la.n) for la in spec.layers] == [(la.name, la.n) for la in jspec.layers]
    spec = _probe_strides(spec)
    with torch.device("meta"):
        GraphModel(spec)
    if spec.layers[-1].name in ("Detect", "Segment", "DetectAux"):
        assert len(spec.strides) == len(dict(spec.layers[-1].kwargs)["anchors"])


@pytest.fixture(scope="module")
def zoo_graph():
    """chip_smoke.py's 6d graph in JAX at 64 px: seeded variables, the eval
    raw maps and decoded output, the train raw maps and running statistics
    (float64), and JAX's init."""
    jm = jax_build_model(chip_smoke.ZOO_6D)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (2, 64, 64, 3), seed=6)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        pred, raw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    train, upd = jax_train_float64(jm.module, v, x, jit=True)
    # JAX's init(imgsz=64): the module's init under PRNGKey(0), then the Detect bias prior
    init = jax.jit(lambda k: jm.module.init(k, jnp.zeros((1, 64, 64, 3)), train=True))(
        jax.random.PRNGKey(0))
    init = jax_initialize_detect_biases(jax_to_mutable(jax.tree_util.tree_map(np.asarray, init)),
                                        jm.spec)
    return {"jm": jm, "v": v, "x": x, "pred": np.asarray(pred), "raw": [np.asarray(r) for r in raw],
            "train": train, "upd": upd, "init": state_dict_from_flax(init)}


def assert_maps_close(got, want, share=1e-5):
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= share * np.abs(w).max(), np.abs(g - w).max()


def test_zoo_graph_matches_jax(zoo_graph):
    """Every registry name 6d adds and each Upsample mode in one detect graph
    with a DetectAux head: JAX's name -> shape map and parameter count, a
    strict load, JAX's strides, raw maps (6 levels) and decoded output in
    eval, and the raw maps and running statistics in train mode."""
    d = chip_smoke.ZOO_6D
    names = {row[2] for row in d["backbone"] + d["head"]}
    assert {"DWConv", "Focus", "CrossConv", "BottleneckCSP", "C3x", "C3SPP", "MixConv2d",
            "Contract", "Expand", "Sum", "nn.BatchNorm2d", "nn.ConvTranspose2d",
            "DWConvTranspose2d"} <= names
    model = build_model(d, device="cpu")
    assert type(model.model[-1]).__name__ == "DetectAux" and model.spec.strides == (8, 16, 32)
    sd = state_dict_from_flax(zoo_graph["v"])
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} \
        == {k: tuple(t.shape) for k, t in sd.items()}
    model.load_state_dict(sd, strict=True)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(zoo_graph["v"]["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    x = to_nchw(zoo_graph["x"])
    with torch.no_grad():
        pred, raw = model.eval()(x)
        assert len(raw) == 6
        assert_maps_close([pred], [zoo_graph["pred"]])
        assert_maps_close(raw, zoo_graph["raw"])
        train = model.train()(x)
    assert_maps_close(train, zoo_graph["train"])
    got = model.state_dict()
    for k, w in state_dict_from_flax({"batch_stats": zoo_graph["upd"]}).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), **TOL, err_msg=k)


def test_zoo_graph_flax_init_equals_jax_init(zoo_graph):
    """flax_init_ against JAX's `init()` (PRNGKey(0), the Detect bias prior on
    DetectAux's lead head): every tensor within 8 float32 ulps, the zeros,
    ones and Sum's gates exact."""
    got = flax_init_(build_model(chip_smoke.ZOO_6D, device="cpu")).state_dict()
    want = zoo_graph["init"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.float32:
            np.testing.assert_array_max_ulp(got[k].numpy(), w.numpy(), maxulp=8)
        else:
            assert torch.equal(got[k], w), k
    np.testing.assert_array_equal(got["model.12.w"].numpy(), [-0.5])


def test_fuse_leaves_the_bottleneck_csp_batchnorm(zoo_graph):
    """JAX's fuse folds every Conv's BatchNorm but leaves BottleneckCSP's
    shared one (and the standalone nn.BatchNorm2d row's) in place
    (tests/test_fuse.py:100); the port's fuse() does the same, and its fused
    raw maps equal JAX's unfused ones within 1e-5 of each map's largest."""
    fused = jax_fuse_conv_bn(zoo_graph["v"], 1e-3)
    assert "bn" in fused["params"]["model_2"] and "bn" in fused["batch_stats"]["model_9"]
    model = build_model(chip_smoke.ZOO_6D, device="cpu")
    model.load_state_dict(state_dict_from_flax(zoo_graph["v"]), strict=True)
    model.eval().fuse()
    assert model.model[2].bn is not None and model.model[2].cv1.bn is None
    assert model.model[9].bn is not None
    with torch.no_grad():
        _, raw = model(to_nchw(zoo_graph["x"]))
    assert_maps_close(raw, zoo_graph["raw"])


def test_jax_graph_of_the_zoo_has_the_port_names(zoo_graph):
    """The trees agree on the names whose JAX form differs from the
    reference's: C3SPP's `m_spp` (port `m`), MixConv2d's `m_{i}`, Sum's `w`
    and DetectAux's `lead` and `m_aux_{i}`."""
    p = zoo_graph["v"]["params"]
    assert "m_spp" in p["model_8"] and set(p["model_6"]) == {"m_0", "m_1", "m_2", "bn"}
    assert p["model_12"]["w"].shape == (1,)
    assert set(p["model_28"]) == {"lead", "m_aux_0", "m_aux_1", "m_aux_2"}
    spec = JaxGraphModel(jax_compiler.parse_config(chip_smoke.ZOO_6D)).spec
    assert spec.layers[8].kw()["k"] == (5, 9, 13) and spec.layers[12].n == 1


def test_seeded_init_covers_the_new_modules():
    """DetectionModel builds on the meta device and draws its weights
    (init_weights): the transposed convs' weights N(0, 1/fan_in) with JAX's
    fan-in k·k·c2, Sum's gates JAX's -arange(1, n)/2, every tensor finite,
    and the 6d graph's outputs of a seeded batch finite and of order 1 (a
    tensor left as to_empty gave it leaves 1e30 outputs)."""
    model = build_model(chip_smoke.ZOO_6D, device="cpu")
    for m in (model.model[11].conv, model.model[24].conv):
        fan_in = m.weight[0].numel()
        assert 0.8 < m.weight.std().item() * fan_in ** 0.5 < 1.2
    np.testing.assert_array_equal(model.model[12].w.detach().numpy(), [-0.5])
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        pred, raw = model.eval()(x)
    assert all(torch.isfinite(t).all() and t.abs().max() < 1e3 for t in (pred, *raw))
