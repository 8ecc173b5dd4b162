"""The AuxOTA slice against the JAX package on the CPU: the SimOTA and AuxOTA
losses (losses/ota.py), the yolov5n_auxota config and its DetectAux head,
one train step through the Trainer, and AutoShape over the lead head.

- The assignment (`idxs`, `fgs`, `matched_gts`) equals JAX's exactly on
  tests/test_ota.py's cases (plain at tests/test_losses.py's sizes,
  conflict-dense, non-square without an explicit pixel scale, AuxOTA) and on
  a case of tied costs and tied IoUs, where the stable sort and the
  first-index argmin keep lax.top_k's and argmin's order.
- Loss items within rtol 1e-5 and atol 1e-6; the gradients with respect to
  the maps within 1e-5 of each map's largest.
- yolov5n_auxota at full width: the JSON copy equals the yaml, JAX's name ->
  shape map and parameter count, a strict load of JAX's tree, JAX's strides,
  raw maps (6 levels) and decoded output within 1e-5 of each map's largest,
  and `flax_init_` within 8 float32 ulps of JAX's init.
- One Trainer.train_step of a narrow yolov5n_auxota (width 1/8, 64 px, bs 2)
  with ComputeLossAuxOTA against JAX's Trainer.make_train_step: loss items
  rtol 1e-4; each parameter's and running statistic's update (after − before)
  within UPDATE_TOL = 1.5% of the largest of JAX's update of that tensor.
  A sound step reads 0.52% at most (a BatchNorm weight whose update is a few
  hundred float32 ulps of the weight); planted optimizer faults read 2.2%
  (momentum 0.9 for 0.937), 2.4% (lr ×1.02), 3.6% (no weight decay) and
  10.3% (lr ×1.1). The step's weight decay is 0.05 (1.56e-3 after the batch
  scaling) so that a fault in it shows in one step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_losses import ANCHORS_PX, HYP, STRIDES, make_targets, rand_preds
from torch_port_common import ROOT, random_variables
from yolo_dual_tpu.engine.autoshape import AutoShape as JaxAutoShape
from yolo_dual_tpu.losses.ota import ComputeLossAuxOTA as JaxAuxOTA
from yolo_dual_tpu.losses.ota import ComputeLossOTA as JaxOTA
from yolo_dual_tpu.models.model import _to_mutable as jax_to_mutable
from yolo_dual_tpu.models.model import build_model as jax_build_model
from yolo_dual_tpu.models.model import initialize_detect_biases as jax_initialize_detect_biases
from yolo_dual_tpu.train import Trainer as JaxTrainer
from yolo_dual_tpu.train import smart_optimizer as jax_smart_optimizer
from yolo_dual_tpu_torch.engine.autoshape import AutoShape
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.losses.ota import ComputeLossAuxOTA, ComputeLossOTA
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.train.optim import smart_optimizer
from yolo_dual_tpu_torch.train.trainer import Trainer
from yolo_dual_tpu_torch.utils.general import find_cfg

JAX_AUX = ROOT / "yolo_dual_tpu" / "configs" / "loss" / "yolov5n_auxota.yaml"
ITEM_TOL = dict(rtol=1e-5, atol=1e-6)


def tied_case():
    """Zero maps (every candidate of a level and anchor decodes to the box of
    its cell at the anchor's size, with equal class costs), gt centres on
    cell edges (mirror-image candidates, equal IoUs) and a duplicated gt
    (equal cost rows, so every candidate both take is a conflict that argmin
    gives the first)."""
    bs, nc, M, size = 2, 3, 4, 64
    preds = [np.zeros((bs, 3, size // s, size // s, 5 + nc), np.float32) for s in STRIDES]
    tgts = np.zeros((bs, M, 5), np.float32)
    tmask = np.zeros((bs, M), bool)
    tgts[0, :3] = [[0, 0.25, 0.25, 0.25, 0.25], [0, 0.25, 0.25, 0.25, 0.25],
                   [1, 0.5, 0.625, 0.375, 0.125]]
    tgts[1, :4] = [[2, 0.375, 0.5, 0.5, 0.5], [1, 0.75, 0.25, 0.125, 0.25],
                   [1, 0.75, 0.25, 0.125, 0.25], [0, 0.5, 0.5, 0.0625, 0.0625]]
    tmask[0, :3] = tmask[1, :4] = True
    return preds, tgts, tmask, nc, size


def conflict_dense_case():
    """tests/test_ota.py:120's clustered gts: candidates claimed by several gts."""
    rng = np.random.default_rng(11)
    bs, nc, M, size = 2, 5, 8, 64
    preds = rand_preds(rng, bs, nc, 0, size)
    tgts = np.zeros((bs, M, 5), np.float32)
    tmask = np.ones((bs, M), bool)
    for b in range(bs):
        for i in range(M):
            tgts[b, i] = [int(rng.integers(0, nc)), *(0.5 + rng.uniform(-0.18, 0.18, 2)),
                          *(rng.uniform(0.25, 0.6, 2) * (1 + 0.05 * i))]
    return preds, tgts, tmask, nc, size


def case(name):
    if name == "plain":  # tests/test_ota.py:34
        rng = np.random.default_rng(11)
        preds = rand_preds(rng, 2, 5, 0, 64)
        return (preds, *make_targets(rng, 2, 6, 5)[:2], 5, 64)
    if name == "conflict_dense":
        return conflict_dense_case()
    if name == "non_square":  # tests/test_ota.py:210, the pixel scale from the maps
        rng = np.random.default_rng(5)
        preds = [rng.standard_normal((2, 3, 64 // s, 128 // s, 10)).astype(np.float32)
                 for s in STRIDES]
        return (preds, *make_targets(rng, 2, 6, 5)[:2], 5, None)
    return tied_case()


CASES = ("plain", "conflict_dense", "non_square", "tied")


def run_both(jax_loss, port_loss, preds, tgts, tmask, size):
    """(JAX's loss, items, grads), (the port's), each grad a list over the maps."""
    jt, jm = jnp.asarray(tgts), jnp.asarray(tmask)
    kw = {} if size is None else {"imgsz": size}
    (jl, ji), jg = jax.jit(jax.value_and_grad(lambda p: jax_loss(p, jt, jm, **kw), has_aux=True))(
        [jnp.asarray(p) for p in preds])
    tp = [torch.tensor(p, requires_grad=True) for p in preds]
    pl, pi = port_loss(tp, torch.from_numpy(tgts), torch.from_numpy(tmask), **kw)
    pl.backward()
    return (float(jl), np.asarray(ji), [np.asarray(g) for g in jg]), \
        (float(pl), pi.numpy(), [p.grad.numpy() for p in tp])


def assert_grads_close(got, want, share=1e-5):
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= share * np.abs(w).max(), (np.abs(g - w).max(),
                                                               np.abs(w).max())


def assert_same_assignment(jax_loss, port_loss, preds, tgts, tmask, size, bias=0.5):
    scale = size if size is not None else jax_loss._pixel_scale([jnp.asarray(p) for p in preds])
    want = jax.jit(lambda p, t, m: jax_loss._simota_select(p, t, m, scale, bias=bias))(
        [jnp.asarray(p) for p in preds], jnp.asarray(tgts), jnp.asarray(tmask))
    got = port_loss._simota_select([torch.from_numpy(p) for p in preds], torch.from_numpy(tgts),
                                   torch.from_numpy(tmask),
                                   torch.from_numpy(np.asarray(scale)), bias=bias)
    for k in ("idxs", "fgs", "matched_gts"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    return got


@pytest.mark.parametrize("name", CASES)
def test_simota_matches_jax(name):
    preds, tgts, tmask, nc, size = case(name)
    jl, pl = JaxOTA(ANCHORS_PX, STRIDES, nc, HYP), ComputeLossOTA(ANCHORS_PX, STRIDES, nc, HYP)
    got = assert_same_assignment(jl, pl, preds, tgts, tmask, size)
    assert got["fgs"].sum() > 0
    if name == "tied":  # the duplicated gt (1 of image 0, 2 of image 1) gets no candidate
        fg, mg = got["fgs"].numpy(), got["matched_gts"].numpy()
        assert not (fg[0] & (mg[0] == 1)).any() and not (fg[1] & (mg[1] == 2)).any()
        assert (fg[0] & (mg[0] == 0)).any() and (fg[1] & (mg[1] == 1)).any()
    want, have = run_both(jl, pl, preds, tgts, tmask, size)
    np.testing.assert_allclose(have[1], want[1], **ITEM_TOL)
    np.testing.assert_allclose(have[0], want[0], **ITEM_TOL)
    assert_grads_close(have[2], want[2])


@pytest.mark.parametrize("name", ["plain", "tied"])
def test_auxota_matches_jax(name):
    """The lead branch and the aux branch (bias-1.0 candidates assigned from
    the lead maps, the loss read from the aux maps at weight 0.25)."""
    preds, tgts, tmask, nc, size = case(name)
    aux = [np.asarray(p[::-1]) * 0.5 + 0.1 for p in preds]  # other maps, same shapes
    jl = JaxAuxOTA(ANCHORS_PX, STRIDES, nc, HYP)
    pl = ComputeLossAuxOTA(ANCHORS_PX, STRIDES, nc, HYP)
    assert_same_assignment(jl, pl, preds, tgts, tmask, size)
    got = assert_same_assignment(jl, pl, preds, tgts, tmask, size, bias=1.0)
    assert got["idxs"].shape[1] == 5 * 3 * 3 * tgts.shape[1]  # C of the bias-1.0 lattice
    want, have = run_both(jl, pl, preds + aux, tgts, tmask, size)
    np.testing.assert_allclose(have[1], want[1], **ITEM_TOL)
    np.testing.assert_allclose(have[0], want[0], **ITEM_TOL)
    assert_grads_close(have[2], want[2])
    assert all(np.abs(g).max() > 0 for g in have[2][3:])  # the aux maps get their gradient


# ---------------------------------------------------------------------------
# yolov5n_auxota and its DetectAux head
# ---------------------------------------------------------------------------


def test_auxota_json_equals_yaml_and_is_found():
    port = find_cfg("yolov5n_auxota.yaml")
    assert port.parent.name == "loss" and find_cfg("loss/yolov5n_auxota.json") == port
    assert json.loads(port.read_text()) == yaml.safe_load(JAX_AUX.read_text())


@pytest.fixture(scope="module")
def auxota():
    """JAX's yolov5n_auxota at full width (nc 2): seeded variables, the eval
    output at 64 px on two frames, and JAX's init (PRNGKey(0), bias prior)."""
    jm = jax_build_model(yaml.safe_load(JAX_AUX.read_text()))
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        pred, raw = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    init = jax.jit(lambda k: jm.module.init(k, jnp.zeros((1, 64, 64, 3)), train=True))(
        jax.random.PRNGKey(0))
    init = jax_initialize_detect_biases(jax_to_mutable(jax.tree_util.tree_map(np.asarray, init)),
                                        jm.spec)
    return {"jm": jm, "v": v, "x": x, "pred": np.asarray(pred), "raw": [np.asarray(r) for r in raw],
            "init": state_dict_from_flax(init)}


def test_auxota_full_width_matches_jax(auxota):
    v = auxota["v"]
    model = build_model("yolov5n_auxota.json", device="cpu")
    head = model.model[-1]
    assert type(head).__name__ == "DetectAux" and model.nc == 2
    assert model.spec.strides == tuple(auxota["jm"].spec.strides) == (8, 16, 32)
    sd = state_dict_from_flax(v)
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} \
        == {k: tuple(t.shape) for k, t in sd.items()}
    assert any(".lead.m.0." in k for k in sd) and any(".m_aux_2." in k for k in sd)
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) \
        == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(v["params"]))
    with torch.no_grad():
        pred, raw = model.eval()(torch.from_numpy(auxota["x"]).permute(0, 3, 1, 2))
    assert len(raw) == 6
    for g, w in zip([pred, *raw], [auxota["pred"], *auxota["raw"]]):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_auxota_flax_init_equals_jax_init(auxota):
    """Every tensor within 8 float32 ulps of JAX's init, the bias prior on the
    lead head's convs only (the aux convs' biases stay 0)."""
    model = flax_init_(build_model("yolov5n_auxota.json", device="cpu"))
    got, want = model.state_dict(), auxota["init"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.float32:
            np.testing.assert_array_max_ulp(got[k].numpy(), w.numpy(), maxulp=8)
        else:
            assert torch.equal(got[k], w), k
    head = f"model.{len(model.model) - 1}"
    assert not got[f"{head}.m_aux_0.bias"].any() and got[f"{head}.lead.m.0.bias"].any()


def test_autoshape_serves_the_lead_head_as_jax(auxota):
    """AutoShape over yolov5n_auxota decodes the lead levels only, as JAX's
    (JAX engine/autoshape.py:120-125): the same rows on three frames."""
    names = {0: "a", 1: "b"}
    frames = [np.random.default_rng(i).integers(0, 256, s, dtype=np.uint8)
              for i, s in enumerate(((48, 80, 3), (64, 64, 3), (90, 50, 3)))]
    want = JaxAutoShape(auxota["jm"], auxota["v"], imgsz=64, conf=0.01, names=names)(frames)
    port = build_model("yolov5n_auxota.json", device="cpu")
    port.load_state_dict(state_dict_from_flax(auxota["v"]), strict=True)
    got = AutoShape(port, imgsz=64, conf=0.01, names=names)(frames)
    assert sum(len(d) for d in want.dets) > 10
    for g, w in zip(got.dets, want.dets):
        order_g, order_w = np.lexsort(g[:, :4].T), np.lexsort(w[:, :4].T)
        np.testing.assert_allclose(g[order_g], w[order_w], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# one train step through the Trainer
# ---------------------------------------------------------------------------

BS, M, IMGSZ = 2, 4, 64


def narrow_auxota():
    d = yaml.safe_load(JAX_AUX.read_text())
    d["width_multiple"] = 0.125
    return d


def detect_batch(seed):
    rng = np.random.default_rng(seed)
    targets = np.zeros((BS, M, 5), np.float32)
    tmask = np.zeros((BS, M), bool)
    for i in range(BS):
        n = 2 + i
        targets[i, :n] = np.concatenate([rng.integers(0, 2, (n, 1)), rng.uniform(0.3, 0.7, (n, 2)),
                                         rng.uniform(0.1, 0.4, (n, 2))], 1)
        tmask[i, :n] = True
    image = rng.integers(0, 256, (BS, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return {"image": image, "targets": targets, "tmask": tmask}


UPDATE_TOL = 0.015
STEP_HYP = {**HYP, "weight_decay": 0.05}


def test_auxota_train_step_matches_jax():
    """Trainer(task="detect", loss_fn=ComputeLossAuxOTA) against JAX's
    Trainer.make_train_step from the same seeded weights, past warmup (every
    parameter group moves): the loss items, and the update of every
    parameter and running statistic."""
    d = narrow_auxota()
    jm = jax_build_model(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), 0)
    kw = jm.spec.layers[-1].kw()
    tx = jax_smart_optimizer(v["params"], "SGD", STEP_HYP, epochs=30, steps_per_epoch=5,
                             total_batch_size=BS)
    tr = JaxTrainer(jm, JaxAuxOTA(kw["anchors"], kw["strides"], 2, HYP), tx, task="detect")
    batch = detect_batch(1)
    s0 = tr.init_state(v)
    s0 = s0.replace(opt_state=s0.opt_state._replace(count=jnp.asarray(100, jnp.int32)))
    with jax.default_matmul_precision("highest"):
        s1, metrics = jax.jit(tr.make_train_step())(s0, {k: jnp.asarray(a) for k, a in
                                                         batch.items()})
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": s1.params, "batch_stats": s1.batch_stats}))

    model = build_model(d, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    head = model.model[-1]
    opt = smart_optimizer(model, "SGD", STEP_HYP, epochs=30, steps_per_epoch=5,
                          total_batch_size=BS)
    opt.count = 100
    trainer = Trainer(model, ComputeLossAuxOTA(head.anchors, head.strides, 2, HYP), opt,
                      task="detect")
    state, out = trainer.train_step(trainer.init_state(), batch)
    np.testing.assert_allclose(out["items"].numpy(), np.asarray(metrics["items"]), rtol=1e-4,
                               atol=1e-6)
    got, start = state.model.state_dict(), state_dict_from_flax(v)
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    for k in keys:
        s0 = start[k].double().numpy()
        du, dw = got[k].double().numpy() - s0, want[k].double().numpy() - s0
        assert np.abs(du - dw).max() <= UPDATE_TOL * np.abs(dw).max(), k
    assert sum(not torch.equal(want[k], start[k]) for k in keys) > 0.9 * len(keys)
