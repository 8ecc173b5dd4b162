"""The YOLO semantic family of the port against the JAX package on the CPU:
yolov5_seg (C3_DCN rows of DCNv2 blocks), yolov8_seg (C2f, C2f_DCN) and
yolov9_seg (C3k2, GAM).

- `deform_conv2d_v2` (an autograd Function for the sampling, a matmul for the
  product) and its plain `deform_conv2d_v2_reference` against JAX's lax
  `deform_conv2d_v2`: groups 1 and 2, stride 1 and 2, two deformable groups,
  the all-ones mask of C2f_DCN, offsets of zero (every point an exact
  integer: `floor` must pick JAX's corner, and so the right neighbour's slope
  in the offset's gradient) and of up to ±3 px past the border. Forward
  1e-5; gradients against `jax.grad` 1e-4 normwise; the Function against
  autograd of the plain version in float64 (1e-10) and by `gradcheck`.
- DCNv2, Bottleneck_DCN, C3_DCN, C2f_DCN, C2f, C3k2 and GAM in eval and in
  train mode: outputs (1e-5) and the updated BatchNorm statistics (1e-5),
  GAM's `conv1` moved twice a forward, GAM at batch 1 in train mode (JAX:
  variance 0, output the BatchNorm bias; torch's batch_norm would raise).
- The full-width configs load a JAX tree with strict=True; the detect
  dialect's C3_DCN (yolov5n-DCN.yaml) builds JAX's tree.
- One train step of each narrow config (calibrated BatchNorm) against JAX's
  `Trainer.make_train_step` past warmup: loss items 1e-4, updates and EMA
  3e-2 normwise (test_torch_port_semantic_train.py's step tolerance, which
  rests on float64 runs of the narrow ResNet50), BatchNorm statistics
  elementwise.
- flax_init_ (semantic.train's starting weights) against JAX's `model.init()`.

`semantic.val` and `semantic.train` on the narrow yolov5_seg are held against
JAX's in test_torch_port_semantic_yolo_cli.py. The JSON copies, the
full-width name -> shape maps, the narrow forwards (fused and unfused), the
optimizer groups and `semantic.predict` are cases of the parametrised tests in
test_torch_port_semantic.py and test_torch_port_semantic_train.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_common import (ROOT, SEM_CFG, SEM_NC, narrow_calibrated, narrow_semantic,
                               random_variables, spread_offsets)
from yolo_dual_tpu.losses import semantic as jax_loss
from yolo_dual_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
from yolo_dual_tpu.nn import common as jax_common
from yolo_dual_tpu.nn import dcn as jax_dcn
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.losses import semantic as port_loss
from yolo_dual_tpu_torch.models.compiler import parse_config
from yolo_dual_tpu_torch.models.model import GraphModel, SemanticSegModel
from yolo_dual_tpu_torch.nn import common, dcn
from yolo_dual_tpu_torch.train.optim import smart_optimizer
from yolo_dual_tpu_torch.train.trainer import Trainer
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

cv2 = pytest.importorskip("cv2")

YOLO = ("yolov5_seg", "yolov8_seg", "yolov9_seg")
DIV = 16  # narrow widths: every width but the class count / 16
IMGSZ = 64
HYP = load_config(find_cfg("hyp.scratch-seg.yaml"))
STEP_RTOL = 3e-2
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nchw_to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_normwise_close(got, want, rtol, atol=1e-6, what=""):
    """max |got − want| ≤ rtol · max |want| + atol, for one tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, (what, err, np.abs(want).max())


def state_dict_close(got, want, start, params, rtol, what):
    """A state_dict after a step against JAX's (carried by state_dict_from_flax):
    each parameter's change normwise, each BatchNorm statistic elementwise."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in params:
            assert_normwise_close(got[k] - start[k], w - start[k], rtol, what=f"{what} {k}")
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# deform_conv2d_v2
# ---------------------------------------------------------------------------

DCN_CASES = {  # name: (b, h, w, cin, cout, stride, groups, deformable groups, offset px, mask)
    "zero_offsets": (2, 9, 11, 8, 6, 1, 1, 1, 0.0, True),
    "g1_s1": (2, 9, 11, 8, 6, 1, 1, 1, 3.0, True),
    "g2_s2": (2, 10, 9, 8, 6, 2, 2, 1, 3.0, True),
    "dg2": (1, 8, 8, 8, 4, 1, 1, 2, 2.5, True),
    "ones_mask": (2, 7, 8, 6, 6, 1, 1, 1, 3.0, False),
    "gradcheck_dg2": (1, 5, 6, 4, 2, 1, 1, 2, 2.5, True),  # small: gradcheck's Jacobians
    "gradcheck_ones_mask": (1, 5, 4, 3, 2, 2, 1, 1, 3.0, False),
}


def dcn_inputs(case, seed=0):
    """Seeded channels-last inputs of JAX's deform_conv2d_v2: offsets U(±px)
    (from every point of an 8-11 px map they reach past the border), a mask in
    (0, 1) or all ones, an HWIO weight."""
    b, h, w, cin, cout, s, g, dg, px, with_mask = DCN_CASES[case]
    rng = np.random.default_rng(seed)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = (rng.uniform(-1, 1, (b, ho, wo, dg * 18)) * px).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, ho, wo, dg * 9)) if with_mask
            else np.ones((b, ho, wo, dg * 9))).astype(np.float32)
    weight = (rng.standard_normal((3, 3, cin // g, cout)) / np.sqrt(9 * cin / g)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return (x, off, mask, weight, bias), (s, 1, 1, g, dg), with_mask


def port_dcn_args(x, off, mask, weight, bias, with_mask):
    return (to_nchw(x), to_nchw(off), to_nchw(mask) if with_mask else None,
            torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias))


@pytest.mark.parametrize("case", sorted(c for c in DCN_CASES if not c.startswith("gradcheck")))
def test_deform_conv2d_v2_matches_jax(case):
    arrays, conf, with_mask = dcn_inputs(case)
    want = np.asarray(jax_dcn.deform_conv2d_v2(*(jnp.asarray(a) for a in arrays), *conf))
    for fn in (dcn.deform_conv2d_v2, dcn.deform_conv2d_v2_reference):
        got = nchw_to_nhwc(fn(*port_dcn_args(*arrays, with_mask), *conf))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=fn.__name__)

    cot = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    argnums = (0, 1, 2, 3, 4) if with_mask else (0, 1, 3, 4)
    jgrads = jax.grad(lambda *a: (jax_dcn.deform_conv2d_v2(*a, *conf) * cot).sum(),
                      argnums=argnums)(*(jnp.asarray(a) for a in arrays))
    ins = [t.requires_grad_(True) if t is not None else None
           for t in port_dcn_args(*arrays, with_mask)]
    out = dcn.deform_conv2d_v2(*ins, *conf).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    layouts = {0: lambda t: t.permute(0, 2, 3, 1), 1: lambda t: t.permute(0, 2, 3, 1),
               2: lambda t: t.permute(0, 2, 3, 1), 3: lambda t: t.permute(2, 3, 1, 0),
               4: lambda t: t}
    for i, jg in zip(argnums, jgrads):
        got = layouts[i](ins[i].grad).numpy()
        jg = np.asarray(jg)
        assert np.linalg.norm(got - jg) <= 1e-4 * np.linalg.norm(jg), (case, i)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "ones_mask"])
def test_deform_sample_backward_float64(with_mask):
    """The autograd Function's hand-written backward against autograd of the
    plain version in float64, and by gradcheck (fractional offsets, away from
    the corners' kinks)."""
    arrays, (s, p, d, g, dg), _ = dcn_inputs("gradcheck_dg2" if with_mask
                                             else "gradcheck_ones_mask", seed=3)
    x, off, mask, weight, bias = (torch.from_numpy(a).double() for a in arrays)
    off = torch.floor(off) + torch.from_numpy(
        np.random.default_rng(4).uniform(0.1, 0.9, off.shape))
    grads = []
    for fn in (dcn.deform_conv2d_v2, dcn.deform_conv2d_v2_reference):
        ins = [to_nchw(x.numpy()).double().requires_grad_(True),
               to_nchw(off.numpy()).double().requires_grad_(True),
               to_nchw(mask.numpy()).double().requires_grad_(True) if with_mask else None,
               weight.permute(3, 2, 0, 1).contiguous().requires_grad_(True),
               bias.clone().requires_grad_(True)]
        out = fn(*ins, s, p, d, g, dg)
        (out * torch.linspace(-1, 1, out.numel(), dtype=torch.float64).view(out.shape)).sum() \
            .backward()
        grads.append([t.grad for t in ins if t is not None])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    xs = (x.requires_grad_(True), off.requires_grad_(True))
    if with_mask:
        xs += (mask.requires_grad_(True),)
    assert torch.autograd.gradcheck(
        lambda *t: dcn._DeformSample.apply(*t, *([None] if not with_mask else []),
                                           3, 3, s, p, d, dg), xs)


# ---------------------------------------------------------------------------
# the modules, eval and train mode
# ---------------------------------------------------------------------------

MODULES = {  # name: (JAX module, port module, NHWC input shape)
    "DCNv2": (lambda: jax_dcn.DCNv2(8), lambda: dcn.DCNv2(6, 8), (2, 8, 9, 6)),
    "DCNv2_s2_g2": (lambda: jax_dcn.DCNv2(8, s=2, g=2), lambda: dcn.DCNv2(8, 8, s=2, g=2),
                    (2, 10, 9, 8)),
    "Bottleneck_DCN": (lambda: jax_dcn.Bottleneck_DCN(8), lambda: dcn.Bottleneck_DCN(8, 8),
                       (2, 8, 8, 8)),
    "C3_DCN": (lambda: jax_dcn.C3_DCN(8, n=2), lambda: dcn.C3_DCN(6, 8, n=2), (2, 8, 8, 6)),
    "C2f_DCN": (lambda: jax_dcn.C2f_DCN(8, n=2), lambda: dcn.C2f_DCN(8, 8, n=2), (2, 8, 8, 8)),
    "C2f": (lambda: jax_common.C2f(8, n=2), lambda: common.C2f(8, 8, n=2), (2, 8, 8, 8)),
    "C3k2": (lambda: jax_common.C3k2(8, n=2), lambda: common.C3k2(6, 8, n=2), (2, 8, 8, 6)),
    "GAM": (lambda: jax_common.GAM(8), lambda: common.GAM(8, 8), (2, 6, 6, 8)),
    "GAM_batch1": (lambda: jax_common.GAM(8), lambda: common.GAM(8, 8), (1, 6, 6, 8)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train):
    """Outputs, and in train mode the updated BatchNorm statistics (GAM's
    conv1 moves twice), from seeded weights whose offset heads spread the
    samples ±2-3 px; C2f_DCN's offsets come from its SiLU offset conv."""
    jmod, pmod, shape = MODULES[name]
    jm = jmod()
    v = spread_offsets(random_variables(lambda k, x: jm.init(k, x, train=False), shape, seed=5),
                       seed=6, gain=2.0)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    port = pmod()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port.train(train)
    with torch.no_grad():
        got = nchw_to_nhwc(port(to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    if train:
        sd = port.state_dict()
        stats = state_dict_from_flax({"batch_stats": upd["batch_stats"]})
        moved = 0
        for k, w in stats.items():
            if k.endswith("num_batches_tracked"):
                calls = 2 if name.startswith("GAM") and k.startswith("conv1.") else 1
                assert sd[k].item() == calls, k
                continue
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), **BN_TOL, err_msg=k)
            moved += not np.array_equal(w.numpy(), state_dict_from_flax(v)[k].numpy())
        assert moved == sum(not k.endswith("num_batches_tracked") for k in stats)
    if name == "GAM_batch1" and train:
        # conv2 / conv3 see one value a channel: their BatchNorm outputs its bias
        with torch.no_grad():
            y = port.conv1(to_nchw(x)).mean((2, 3), keepdim=True)
            np.testing.assert_allclose(port.conv2.bn(port.conv2.conv(y)).flatten().numpy(),
                                       port.conv2.bn.bias.numpy(), rtol=0, atol=1e-6)


def test_gam_at_batch1_trains_as_jax():
    """GAM at batch 1 in train mode: the gradients of its input and of every
    parameter against jax.grad (its pooled BatchNorms pass no gradient back
    through the one value a channel, as in JAX)."""
    jm = jax_common.GAM(8)
    v = random_variables(lambda k, x: jm.init(k, x, train=False), (1, 6, 6, 8), seed=8)
    x = np.random.default_rng(9).standard_normal((1, 6, 6, 8)).astype(np.float32)
    cot = np.random.default_rng(10).standard_normal((1, 6, 6, 8)).astype(np.float32)

    def f(params, x):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return (out * cot).sum()
    gp, gx = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x))
    port = common.GAM(8, 8)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    xt = to_nchw(x).clone().requires_grad_(True)
    out = port.train()(xt).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    assert_normwise_close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), 1e-5, what="dx")
    params = dict(port.named_parameters())
    for k, g in state_dict_from_flax({"params": gp}).items():
        assert_normwise_close(params[k].grad.numpy(), g.numpy(), 1e-5, what=k)


# ---------------------------------------------------------------------------
# full-width configs; JAX's initial weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", YOLO + ("resnet50",))
def test_flax_init_equals_jax_model_init(name):
    """flax_init_ (what semantic.train starts from) against JAX's
    `model.init()` (PRNGKey(0)) of the narrow config: every tensor within 8
    float32 ulps (XLA's erf_inv and fused multiply-adds copied; measured at
    most 4 ulps on ~0.5% of the values), the zeros and ones exact."""
    from yolo_dual_tpu_torch.models.flax_init import flax_init_
    d = narrow_semantic(name, DIV)
    jm = JaxSemanticSegModel(d)  # jitted, JAX's model.init (same keys, same values)
    x = jnp.zeros((1, IMGSZ, IMGSZ, 3), jnp.float32)
    want = state_dict_from_flax(jax.jit(lambda k: jm.module.init(k, x, train=True))(
        jax.random.PRNGKey(0)))
    got = flax_init_(SemanticSegModel(d, device="cpu")).state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.float32:
            np.testing.assert_array_max_ulp(got[k].numpy(), w.numpy(), maxulp=8)
        else:
            assert torch.equal(got[k], w), k


@pytest.mark.parametrize("name", YOLO)
def test_full_width_loads_jax_weights_strict(name):
    """The JSON config at full width (nc 12) loads a seeded JAX tree of the
    yaml with strict=True; the raw deformable weights arrive as OIHW."""
    jm = JaxSemanticSegModel(yaml.safe_load((SEM_CFG / f"{name}.yaml").read_text()))
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), 0)
    model = SemanticSegModel(f"{name}.json", device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    assert model.nc == SEM_NC
    p = v["params"]
    if name == "yolov5_seg":
        w, t = p["model_4"]["m_5"]["cv2"]["weight"], model.model[4].m[5].cv2.weight
    elif name == "yolov8_seg":
        w, t = p["model_8"]["m_0_dcn_weight"], model.model[8].m_0_dcn_weight
    else:
        w, t = p["model_9"]["conv1"]["conv"]["kernel"], model.model[9].conv1.conv.weight
    np.testing.assert_array_equal(t.detach().numpy(), w.transpose(3, 2, 0, 1))


def test_detect_dialect_c3_dcn_matches_jax_tree():
    """yolov5n-DCN.yaml (Detect head; C3_DCN rows whose row repeat the
    compiler inserts as n, then width- and depth-scaled): the port's meta build
    has JAX's name -> shape map and parameter count."""
    d = yaml.safe_load((ROOT / "yolo_dual_tpu" / "configs" / "backbone" / "yolov5n-DCN.yaml")
                       .read_text())
    jm = JaxDetectionModel(d)
    shapes = jax.eval_shape(lambda k, x: jm.module.init(k, x, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(zeros).items()}
    with torch.device("meta"):
        model = GraphModel(parse_config(d))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if k.rsplit(".", 1)[-1] not in ("anchors", "anchor_grid")}
    assert got == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    rows = {layer.i: layer for layer in model.spec.layers}
    assert [rows[i].kw()["n"] for i in (4, 6, 8)] == [2, 3, 1]
    assert sum(isinstance(m, dcn.DCNv2) for m in model.modules()) == 6


# ---------------------------------------------------------------------------
# one train step of each narrow config
# ---------------------------------------------------------------------------

BS = 2


def semantic_batch(seed):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, SEM_NC, (BS, IMGSZ, IMGSZ)).astype(np.int32)
    colours = rng.integers(0, 256, (SEM_NC, 3))
    image = np.clip(colours[mask] + rng.integers(-30, 31, (BS, IMGSZ, IMGSZ, 3)), 0, 255)
    return {"image": image.astype(np.uint8), "mask": mask}


@pytest.mark.parametrize("name", YOLO)
def test_train_step_matches_jax(name):
    """One train_step (SGD, hyp.scratch-seg, dice, EMA, accumulate 1, past
    warmup) of the narrow config from calibrated weights: loss items 1e-4,
    every update and EMA value 3e-2 normwise, every BatchNorm statistic
    elementwise (1e-3 / 1e-4)."""
    batch = semantic_batch(1)
    d, jm, v = narrow_calibrated(name, DIV, 3, batch["image"])
    loss = jax_loss.SemanticSegLoss(SEM_NC)
    with jax.default_matmul_precision("highest"):
        tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=3, steps_per_epoch=4,
                               accumulate=1, total_batch_size=BS)
        from yolo_dual_tpu.train import ModelEMA as JModelEMA
        tr = JTrainer(jm, loss, tx, ema=JModelEMA(), task="semantic", accumulate=1)
        s = tr.init_state(v)
        s = s.replace(opt_state=s.opt_state._replace(count=jnp.asarray(100, jnp.int32)))
        s1, metrics = jax.jit(tr.make_train_step())(s, {k: jnp.asarray(a)
                                                       for k, a in batch.items()})
    want_state = state_dict_from_flax({"params": s1.params, "batch_stats": s1.batch_stats})
    want_ema = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, s1.ema)["ema"])

    from yolo_dual_tpu_torch.train.ema import ModelEMA
    model = SemanticSegModel(d, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    opt = smart_optimizer(model, "SGD", HYP, epochs=3, steps_per_epoch=4, accumulate=1,
                          total_batch_size=BS)
    opt.count = 100
    ptr = Trainer(model, port_loss.SemanticSegLoss(SEM_NC), opt, ModelEMA(model),
                  task="semantic")
    state = ptr.init_state()
    start = {k: t.clone() for k, t in model.state_dict().items()}
    state, pm = ptr.train_step(state, batch)
    np.testing.assert_allclose(pm["items"].numpy(), np.asarray(metrics["items"]), rtol=1e-4,
                               atol=1e-7)
    # past warmup an update is the learning rate times the Nesterov step of the
    # gradient plus weight decay, so the updates hold the gradients too; yolov5_seg's
    # head rows 12-20 feed no output (row 23 concatenates rows 22 and 11): autograd
    # leaves them no gradient, JAX a zero one, and weight decay moves both alike
    params = dict(model.named_parameters())
    state_dict_close(model.state_dict(), want_state, start, params, STEP_RTOL, "model")
    state_dict_close(state.ema.ema.state_dict(), want_ema, start, params, STEP_RTOL, "ema")
