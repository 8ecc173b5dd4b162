"""The port's training slice against the JAX package: bbox_iou, the target
assignment, the detection and segmentation losses, the optimizer with its
schedules and accumulation, the EMA, train-mode BatchNorm, and one whole train
step of a nano yolov5n-seg with C3_DCNV3 rows against JAX's
`Trainer.make_train_step`.

Inputs and weights are made with numpy from a seed and handed to both. JAX
matmuls run at "highest" precision. Tolerances, float32 throughout:
- elementwise parts (IoU, assignment, optimizer, EMA): rtol 1e-5 or tighter,
  since both sides do the same arithmetic in the same order;
- losses and their gradients: rtol 1e-4 (sums in different orders);
- the whole step's gradients and updates, per tensor: max |port − JAX| ≤
  4e-3 · max |JAX| + 1e-6. Through ~25 layers of backward, JAX's float32
  gradients lie up to 1.9e-3 (of a tensor's largest) from a float64 run of the
  port, the port's float32 ones within 3.3e-4 (held below at 1e-3): JAX's
  BatchNorm takes its variance as E[x²] − E[x]² in float32. The + 1e-6 covers
  gradients that are zero but for rounding (a bias that a BatchNorm follows);
- and elementwise, rtol 1e-3 / atol 1e-4: every new parameter and EMA value,
  and the gradients of the leaves that the loss reaches through few
  BatchNorms (`held_elementwise`: the head, rows 10 on, and the DCNv3 of the
  last C3_DCNV3, row 8). Deeper in the backbone even the port's own float32
  gradients leave float64 by more than that in single elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from torch_port_common import ROOT, random_variables
from yolo_dual_tpu.losses.detect import ComputeLoss as JComputeLoss
from yolo_dual_tpu.losses.detect import build_targets_level as j_build_targets_level
from yolo_dual_tpu.losses.segment import ComputeSegmentLoss as JComputeSegmentLoss
from yolo_dual_tpu.losses.segment import _compact_per_image as j_compact_per_image
from yolo_dual_tpu.losses.segment import encode_overlap_masks as j_encode_overlap_masks
from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
from yolo_dual_tpu.nn.common import Conv as JConv
from yolo_dual_tpu.ops.boxes import bbox_iou as j_bbox_iou
from yolo_dual_tpu.train import EarlyStopping as JEarlyStopping
from yolo_dual_tpu.train import ModelEMA as JModelEMA
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu.train.optim import build_lr_schedule as j_build_lr_schedule
from yolo_dual_tpu.train.optim import build_momentum_schedule as j_build_momentum_schedule
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.losses.detect import ComputeLoss, build_targets_level
from yolo_dual_tpu_torch.losses.segment import (
    ComputeSegmentLoss, _compact_per_image, encode_overlap_masks)
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.nn.common import Conv
from yolo_dual_tpu_torch.ops.boxes import bbox_iou
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import (
    build_lr_schedule, build_momentum_schedule, param_group_label, smart_optimizer)
from yolo_dual_tpu_torch.train.trainer import EarlyStopping, Trainer
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

HYP = load_config(find_cfg("hyp.scratch-low.yaml"))
ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
STRIDES = (8, 16, 32)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def highest():
    return jax.default_matmul_precision("highest")


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def assert_normwise_close(got, want, rtol, atol=1e-6, what=""):
    """max |got − want| ≤ rtol · max |want| + atol, for one tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, (what, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# boxes and losses
# ---------------------------------------------------------------------------

def box_pairs(seed, n=64, xywh=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    wh = rng.uniform(0.5, 5, (n, 2))
    xy2 = xy + rng.normal(0, 1.5, (n, 2))  # most pairs overlap, some do not
    wh2 = wh * rng.uniform(0.5, 2, (n, 2))
    if xywh:
        b1, b2 = np.concatenate([xy, wh], 1), np.concatenate([xy2, wh2], 1)
    else:
        b1, b2 = np.concatenate([xy, xy + wh], 1), np.concatenate([xy2, xy2 + wh2], 1)
    return b1.astype(np.float32), b2.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False], ids=["xywh", "xyxy"])
@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU", "SIoU", "EIoU"])
def test_bbox_iou_matches_jax(kind, xywh):
    """Values and the gradients of their sum, in both box arguments."""
    b1, b2 = box_pairs(len(kind), xywh=xywh)
    kw = {} if kind == "IoU" else {kind: True}
    want = j_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, **kw)
    wg = jax.grad(lambda a, b: j_bbox_iou(a, b, xywh=xywh, **kw).sum(), argnums=(0, 1))(
        jnp.asarray(b1), jnp.asarray(b2))
    p1, p2 = t(b1, True), t(b2, True)
    got = bbox_iou(p1, p2, xywh=xywh, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for g, w in zip((p1.grad, p2.grad), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def detect_inputs(seed, bs=2, M=5, nc=4, nm=0, imgsz=128, proto=True):
    """Padded targets with 1..M boxes per image, 3 raw level maps for a
    128-px input (16, 8 and 4 cells), and NCHW protos (bs, nm, 32, 32)."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((bs, M, 5), np.float32)
    tmask = np.zeros((bs, M), bool)
    for i in range(bs):
        n = rng.integers(1, M + 1)
        targets[i, :n, 0] = rng.integers(0, nc, n)
        targets[i, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        targets[i, :n, 3:5] = rng.uniform(0.03, 0.6, (n, 2))
        tmask[i, :n] = True
    maps = [rng.normal(0, 1, (bs, 3, imgsz // s, imgsz // s, 5 + nc + nm)).astype(np.float32)
            for s in STRIDES]
    protos = rng.normal(0, 1, (bs, nm, imgsz // 4, imgsz // 4)).astype(np.float32) if nm else None
    return targets, tmask, maps, protos


def test_build_targets_level_matches_jax():
    targets, tmask, maps, _ = detect_inputs(0, bs=3, M=6)
    jl, pl = JComputeLoss(ANCHORS, STRIDES, 4, HYP), ComputeLoss(ANCHORS, STRIDES, 4, HYP)
    for i, m in enumerate(maps):
        ny, nx = m.shape[2:4]
        want = j_build_targets_level(jnp.asarray(targets), jnp.asarray(tmask), jl.anchors_grid[i],
                                     ny, nx, 4.0)
        got = build_targets_level(t(targets), t(tmask), pl.anchors_grid[i], ny, nx, 4.0)
        assert got.valid.any()
        for f in ("b", "a", "gj", "gi", "cls", "tidx", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
        for f in ("tbox", "xywhn", "anch"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("fl_gamma", [0.0, 1.5], ids=["bce", "focal"])
def test_compute_loss_matches_jax(fl_gamma):
    """Loss, items and the gradient in every raw level map."""
    targets, tmask, maps, _ = detect_inputs(1)
    hyp = dict(HYP, fl_gamma=fl_gamma)
    jl = JComputeLoss(ANCHORS, STRIDES, 4, hyp)
    (wl, witems), wg = jax.jit(jax.value_and_grad(
        lambda ps: jl(ps, jnp.asarray(targets), jnp.asarray(tmask)), has_aux=True))(
        [jnp.asarray(m) for m in maps])
    ps = [t(m, True) for m in maps]
    loss, items = ComputeLoss(ANCHORS, STRIDES, 4, hyp)(ps, t(targets), t(tmask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(wl), **LOSS_TOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(witems), **LOSS_TOL)
    for p, g in zip(ps, wg):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "per_instance"])
def test_compute_segment_loss_matches_jax(overlap):
    """Loss, items and gradients in the level maps and the protos. The GT masks
    come at 48 px (overlap) or 20 px (per instance) and are resized to the
    32-px protos by nearest neighbour, with instances inside their boxes."""
    nm = 4
    targets, tmask, maps, protos = detect_inputs(2, nm=nm)
    bs, M = tmask.shape
    size = 48 if overlap else 20
    inst = np.zeros((bs, M, size, size), np.float32)
    for i in range(bs):
        for j in np.flatnonzero(tmask[i]):
            cx, cy, w, h = targets[i, j, 1:] * size
            inst[i, j, int(cy - h / 4):int(cy + h / 4) + 1, int(cx - w / 4):int(cx + w / 4) + 1] = 1
    masks = np.stack([encode_overlap_masks(m)[0] for m in inst]) if overlap else inst
    if overlap:  # the overlap plane indexes instances in area order: renumber targets to match
        for i in range(bs):
            order = encode_overlap_masks(inst[i])[1]
            targets[i] = targets[i][order]
            tmask[i] = tmask[i][order]
    jl = JComputeSegmentLoss(ANCHORS, STRIDES, 4, nm, HYP, overlap=overlap)
    (wl, witems), wg = jax.jit(jax.value_and_grad(
        lambda ps, pr: jl((ps, pr), jnp.asarray(targets), jnp.asarray(tmask), jnp.asarray(masks)),
        argnums=(0, 1), has_aux=True))([jnp.asarray(m) for m in maps],
                                       jnp.asarray(protos.transpose(0, 2, 3, 1)))
    ps, pr = [t(m, True) for m in maps], t(protos, True)
    loss, items = ComputeSegmentLoss(ANCHORS, STRIDES, 4, nm, HYP, overlap=overlap)(
        (ps, pr), t(targets), t(tmask), t(masks))
    loss.backward()
    assert items[1] > 0  # the mask branch has positives
    np.testing.assert_allclose(loss.item(), float(wl), **LOSS_TOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(witems), **LOSS_TOL)
    for p, g in zip(ps, wg[0]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(pr.grad.numpy(), np.asarray(wg[1]).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("capacity", [3, 17, 45])
def test_compact_per_image_matches_top_k(capacity):
    """The stable-sort selection picks JAX's top_k set, including when an
    image has more positives than the capacity (3, 17) and fewer (45)."""
    targets, tmask, _, _ = detect_inputs(3, bs=3, M=5)
    anchors = JComputeLoss(ANCHORS, STRIDES, 4, HYP).anchors_grid[0]
    ja = j_build_targets_level(jnp.asarray(targets), jnp.asarray(tmask), anchors, 16, 16, 4.0)
    pa = build_targets_level(t(targets), t(tmask), t(anchors), 16, 16, 4.0)
    want_idx, want_val = j_compact_per_image(ja, 3, capacity)
    idx, val = _compact_per_image(pa, 3, capacity)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(want_val))


def test_encode_overlap_masks_matches_jax():
    rng = np.random.default_rng(4)
    inst = (rng.uniform(size=(5, 12, 10)) < rng.uniform(0.1, 0.6, (5, 1, 1))).astype(np.uint8)
    got, order = encode_overlap_masks(inst)
    want, want_order = j_encode_overlap_masks(inst)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(order, want_order)


# ---------------------------------------------------------------------------
# optimizer, schedules, EMA, BatchNorm
# ---------------------------------------------------------------------------

def test_hyp_json_equals_the_yaml():
    with open(ROOT / "yolo_dual_tpu" / "configs" / "hyps" / "hyp.scratch-low.yaml") as f:
        assert HYP == yaml.safe_load(f)


@pytest.mark.parametrize("cos_lr", [False, True], ids=["linear", "one_cycle"])
def test_schedules_match_jax(cos_lr):
    """lr of the weight and bias groups and the momentum over warmup (the
    first 100 data iterations) and past it, at accumulate 4."""
    kw = dict(epochs=5, steps_per_epoch=10, cos_lr=cos_lr, accumulate=4)
    for group in ("g0", "g2"):
        want, got = j_build_lr_schedule(HYP, group=group, **kw), build_lr_schedule(HYP, group=group, **kw)
        for step in range(0, 70, 3):
            np.testing.assert_allclose(got(step), float(want(jnp.asarray(step, jnp.int32))),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{group} step {step}")
    jm, pm = j_build_momentum_schedule(HYP, 10, 4), build_momentum_schedule(HYP, 10, 4)
    for step in range(0, 40, 3):
        np.testing.assert_allclose(pm(step), float(jm(jnp.asarray(step, jnp.int32))), rtol=1e-6)


OPT_TREE = {"conv": {"kernel": (3, 3, 2, 4)}, "bn": {"scale": (4,), "bias": (4,)},
            "head": {"kernel": (4, 6), "bias": (6,)}}


def numpy_tree(rng, shapes=OPT_TREE, scale=1.0):
    return {m: {k: (rng.normal(0, scale, s)).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in shapes.items()}


@pytest.mark.parametrize("name", ["SGD", "AdamW", "RMSProp"])
def test_smart_optimizer_matches_jax(name):
    """Six micro-steps at accumulate 2 from the same weights and gradients:
    updates only on every second call, the warmup lr and momentum, the bias
    group's warmup_bias_lr, decay only on the weights (scaled by bs 8 ·
    accumulate 2 / 64). The parameters' total change is held to rtol 1e-5,
    and to 5e-7 absolute: two float32 ulps of a parameter below 4, which is
    what rounding p + u to float32 leaves."""
    rng = np.random.default_rng(5)
    params = numpy_tree(rng)
    kw = dict(hyp=HYP, epochs=3, steps_per_epoch=4, accumulate=2, total_batch_size=8)
    tx = j_smart_optimizer(jax.tree_util.tree_map(jnp.asarray, params), name, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    port = {k: torch.nn.Parameter(v) for k, v in state_dict_from_flax({"params": params}).items()}
    assert [param_group_label(k) for k in port] == ["g0", "g1", "g2", "g0", "g2"]
    opt = smart_optimizer(port.items(), name, **kw)
    stepped = []
    for _ in range(6):
        grads = numpy_tree(rng)
        updates, jstate = update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in state_dict_from_flax({"params": grads}).items():
            port[k].grad = g
        stepped.append(opt.step())
    assert stepped == [False, True] * 3 and opt.count == 3
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jparams)})
    start = state_dict_from_flax({"params": params})
    for k, p in port.items():
        assert not torch.equal(p.detach(), start[k]), k
        np.testing.assert_allclose((p.detach() - start[k]).numpy(), (want[k] - start[k]).numpy(),
                                   rtol=1e-5, atol=5e-7, err_msg=k)


def conv_variables(rng):
    """Variables of a JAX Conv(4, 3) on 2 channels, in the tree JAX's Conv has."""
    p = numpy_tree(rng, {"conv": {"kernel": (3, 3, 2, 4)}, "bn": {"scale": (4,), "bias": (4,)}})
    s = numpy_tree(rng, {"bn": {"mean": (4,), "var": (4,)}})
    s["bn"]["var"] = np.abs(s["bn"]["var"]) + 0.5
    return {"params": p, "batch_stats": s}


def test_model_ema_matches_jax():
    """Three updates from the same start: the float parameters and running
    stats blend as JAX's do; num_batches_tracked is copied, not blended."""
    rng = np.random.default_rng(6)
    v0 = conv_variables(rng)
    model = Conv(2, 4, 3)
    model.load_state_dict(state_dict_from_flax(v0), strict=True)
    ema, jema = ModelEMA(model, decay=0.99, tau=2.0), JModelEMA(decay=0.99, tau=2.0)
    jstate = jema.init(jax.tree_util.tree_map(jnp.asarray, v0))
    for i in range(3):
        v = conv_variables(rng)
        sd = state_dict_from_flax(v)
        sd["bn.num_batches_tracked"] = torch.tensor(i + 5)
        model.load_state_dict(sd, strict=True)
        ema.update(model)
        jstate = jema.update(jstate, jax.tree_util.tree_map(jnp.asarray, v))
    assert ema.updates == int(jstate["updates"]) == 3
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate["ema"]))
    got = ema.ema.state_dict()
    assert got["bn.num_batches_tracked"].item() == 7
    for k, w in want.items():
        if w.is_floating_point():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_mode_batchnorm_matches_jax():
    """One train-mode forward of Conv + BN + SiLU: the output, and the running
    mean and the biased running variance at momentum 0.97 (flax) / 0.03."""
    rng = np.random.default_rng(7)
    v = conv_variables(rng)
    x = rng.normal(0.3, 1.5, (2, 6, 5, 2)).astype(np.float32)
    with highest():
        want, upd = JConv(4, 3).apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x),
                                      train=True, mutable=["batch_stats"])
    model = Conv(2, 4, 3).train()
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    got = model(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    stats = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(model.state_dict()[k].numpy(), stats[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert model.bn.num_batches_tracked.item() == 1


def test_early_stopping_matches_jax():
    fitness = [0.1, 0.3, 0.2, 0.25, 0.3, 0.1, 0.05, 0.4, 0.1, 0.1, 0.1]
    port, ref = EarlyStopping(patience=3), JEarlyStopping(patience=3)
    for epoch, f in enumerate(fitness):
        assert port(epoch, f) == ref(epoch, f)
        assert (port.best_epoch, port.possible_stop) == (ref.best_epoch, ref.possible_stop)


# ---------------------------------------------------------------------------
# one whole train step of a nano C3_DCNV3 model
# ---------------------------------------------------------------------------

DCN_ROWS = (4, 6, 8)  # as tests/test_torch_port_dcn.py:dcn_cfg
BS, M, IMGSZ, STEPS_PER_EPOCH, EPOCHS = 2, 4, 64, 5, 30
ELEMENT_TOL = dict(rtol=1e-3, atol=1e-4)


def held_elementwise(name: str) -> bool:
    """Leaves whose gradient is held elementwise: the head (rows 10 on) and
    the DCNv3 (offset, mask, dw_conv, projections) of row 8's C3_DCNV3."""
    row = int(name.split(".")[1])
    return row >= 10 or (row == DCN_ROWS[-1] and ".dcnv3." in name)


def seg_batch(seed):
    """A batch as the JAX loader yields it: uint8 NHWC images, padded
    targets, and 16-px overlap-indexed masks with each instance in its box."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((BS, M, 5), np.float32)
    tmask = np.zeros((BS, M), bool)
    masks = np.zeros((BS, IMGSZ // 4, IMGSZ // 4), np.float32)
    for i in range(BS):
        for j in range(3):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            targets[i, j] = [rng.integers(0, 80), cx, cy, w, h]
            tmask[i, j] = True
            s = IMGSZ // 4
            masks[i, int((cy - h / 4) * s):int((cy + h / 4) * s) + 1,
                  int((cx - w / 4) * s):int((cx + w / 4) * s) + 1] = j + 1
    image = rng.integers(0, 256, (BS, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return {"image": image, "targets": targets, "tmask": tmask, "masks": masks}


def nano_dcn_cfg():
    d = load_config(find_cfg("yolov5n-seg.json"))
    for r in DCN_ROWS:
        d["backbone"][r][2] = "C3_DCNV3"
    return d


@pytest.fixture(scope="module")
def nano_step():
    """JAX's train step, jitted once, from seeded weights: run at inner step
    count 0 (in warmup: only the bias group moves, at warmup_bias_lr) and at
    count 100 (past warmup: every group moves), plus the gradients."""
    d = nano_dcn_cfg()
    jm = JaxSegmentationModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3), seed=0)
    kw = jm.spec.layers[-1].kw()
    loss = JComputeSegmentLoss(kw["anchors"], kw["strides"], 80, 32, HYP, overlap=True)
    tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                           total_batch_size=BS)
    tr = JTrainer(jm, loss, tx, ema=JModelEMA(), task="segment")
    train_step = tr.make_train_step()
    grad_fn = jax.grad(tr._forward_loss, has_aux=True)
    step = jax.jit(lambda s, b: (train_step(s, b), grad_fn(s.params, s.batch_stats, b)[0]))
    batch = seg_batch(1)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    s0 = tr.init_state(v)
    out = {"cfg": d, "v": v, "batch": batch}
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    with highest():
        for count in (0, 100):
            s = s0.replace(opt_state=s0.opt_state._replace(count=jnp.asarray(count, jnp.int32)))
            (s1, metrics), grads = step(s, jb)
            out[count] = {"state": to_np({"params": s1.params, "batch_stats": s1.batch_stats}),
                          "ema": to_np(s1.ema), "items": np.asarray(metrics["items"]),
                          "loss": float(metrics["loss"]), "grads": to_np(grads)}
    return out


def port_trainer(nano_step, dtype=torch.float32, count=0):
    model = SegmentationModel(nano_step["cfg"], device="cpu")
    model.load_state_dict(state_dict_from_flax(nano_step["v"]), strict=True)
    model = model.to(dtype)
    kw = model.model[-1]
    loss = ComputeSegmentLoss(kw.anchors, kw.strides, 80, 32, HYP, overlap=True)
    opt = smart_optimizer(model, "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                          total_batch_size=BS)
    opt.count = count
    tr = Trainer(model, loss, opt, ModelEMA(model))
    return tr, tr.init_state()


@pytest.mark.parametrize("count", [0, 100], ids=["warmup", "past_warmup"])
def test_nano_dcnv3_train_step_matches_jax(nano_step, count):
    """Loss items, every gradient, the update of every parameter, the new
    BatchNorm statistics and the EMA after one train_step, against JAX's."""
    want = nano_step[count]
    tr, state = port_trainer(nano_step, count=count)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = tr.train_step(state, nano_step["batch"])
    np.testing.assert_allclose(metrics["items"].numpy(), want["items"], **LOSS_TOL)
    np.testing.assert_allclose(metrics["loss"].item(), want["loss"], **LOSS_TOL)
    params = dict(state.model.named_parameters())
    wg = state_dict_from_flax({"params": want["grads"]})
    assert wg.keys() == params.keys()
    for k, g in wg.items():
        assert_normwise_close(params[k].grad, g, 4e-3, what=f"grad {k}")
        if held_elementwise(k):
            np.testing.assert_allclose(params[k].grad.numpy(), g.numpy(), **ELEMENT_TOL,
                                       err_msg=f"grad {k}")
    assert sum(map(held_elementwise, wg)) > len(wg) // 3  # 98 of 279 leaves
    new = state.model.state_dict()
    for k, w in state_dict_from_flax(want["state"]).items():
        if k.endswith("num_batches_tracked"):
            assert new[k].item() == 1, k
        elif k in params:  # the update, normwise as the gradient, and the new value elementwise
            assert_normwise_close(new[k] - start[k], w - start[k], 4e-3, what=f"update {k}")
            np.testing.assert_allclose(new[k].numpy(), w.numpy(), **ELEMENT_TOL, err_msg=k)
        else:  # running stats
            np.testing.assert_allclose(new[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
    # in warmup the weights' lr is 0 and only biases move; past it every group
    # moves (a bias whose gradient is zero but for rounding may not)
    moved = {k for k in params if not torch.equal(new[k], start[k])}
    labels = {k: param_group_label(k) for k in params}
    movable = {k for k in params if count or labels[k] == "g2"}
    assert moved <= movable and len(moved) >= 0.95 * len(movable)
    assert count == 0 or {labels[k] for k in moved} == {"g0", "g1", "g2"}
    assert state.ema.updates == int(want["ema"]["updates"]) == 1
    ema = state.ema.ema.state_dict()
    for k, w in state_dict_from_flax(want["ema"]["ema"]).items():
        if k in params:  # nearly the new parameters after one update: held as the update
            assert_normwise_close(ema[k] - start[k], w - start[k], 4e-3, what=f"ema {k}")
        if w.is_floating_point():
            np.testing.assert_allclose(ema[k].numpy(), w.numpy(), rtol=1e-3, atol=1e-4, err_msg=k)


def test_nano_dcnv3_gradients_float32_against_float64(nano_step):
    """The port's float32 gradients against its own float64 run, per tensor
    within 1e-3 of the tensor's largest: the float32 rounding of the port."""
    batch = dict(nano_step["batch"])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tr, state = port_trainer(nano_step, dtype)
        b = dict(batch, image=(batch["image"] / 255.0).astype(np.float32 if dtype == torch.float32
                                                              else np.float64))
        b["targets"] = batch["targets"].astype(b["image"].dtype)
        loss, _ = tr.forward_loss(state.model.train(), b)
        loss.backward()
        grads[dtype] = {k: p.grad.double() for k, p in state.model.named_parameters()}
    for k, g in grads[torch.float64].items():
        assert_normwise_close(grads[torch.float32][k], g, 1e-3, what=k)
        if held_elementwise(k):
            np.testing.assert_allclose(grads[torch.float32][k].numpy(), g.numpy(), **ELEMENT_TOL,
                                       err_msg=k)


def test_train_step_accumulates_and_steps_the_ema_on_real_steps(nano_step):
    """At accumulate 2 the parameters move only on every second micro-step,
    the EMA advances only then, BatchNorm statistics move every micro-step,
    and eval_step runs the EMA model."""
    tr, state = port_trainer(nano_step)
    state.optimizer = smart_optimizer(state.model, "SGD", HYP, epochs=EPOCHS,
                                      steps_per_epoch=STEPS_PER_EPOCH, accumulate=2,
                                      total_batch_size=BS)
    params = dict(state.model.named_parameters())
    for i in range(4):
        before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        state, metrics = tr.train_step(state, seg_batch(10 + i))
        assert torch.isfinite(metrics["items"]).all()
        after = state.model.state_dict()
        changed = {k for k in after if not torch.equal(after[k], before[k])}
        assert any(k.endswith("running_mean") for k in changed)
        assert bool(changed & params.keys()) == (i % 2 == 1), i
    assert (state.step, state.optimizer.count, state.ema.updates) == (4, 2, 2)
    pred, protos, raw = tr.eval_step(state, seg_batch(20))
    assert pred.shape == (BS, 3 * (8 * 8 + 4 * 4 + 2 * 2), 85 + 32) and protos.shape == (BS, 32, 16, 16)
    assert not state.ema.ema.training
