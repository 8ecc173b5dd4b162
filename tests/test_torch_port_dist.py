"""The port's data parallelism (parallel/mesh.py) on 2 gloo ranks against the
JAX package: one train step of the segment, semantic (CE + Dice) and
classify models against JAX's `Trainer(mesh=make_mesh(2))` on conftest's
virtual CPU devices and JAX's one-device step on the same global batch;
data-parallel `evaluate_segment` / `evaluate_semantic` against JAX's mesh
evaluation and the port's one-process run; the Loader's shards against JAX's
`Loader(num_shards=2, shard_index=r)`; the synchronised BatchNorm against
flax's BatchNorm over the global batch.

Each rank is a process of its own (tests/torch_port_dist_worker.py) joined
through a FileStore under tmp_path; every join has a deadline. Tolerances,
float32:
- loss items: rtol 1e-4 against JAX (sums in other orders), 2e-5 between the
  port's two runs and between JAX's two;
- the step's parameter updates and EMA changes per tensor: max |got − want|
  ≤ 4e-3 · max |want| + 1e-6 against JAX (tests/test_torch_port_train.py's
  bound: JAX's BatchNorm variance is E[x²] − E[x]² in float32), 1e-4 · max +
  1e-6 between the port's 2-rank and one-process runs (the + 1e-6 covers
  updates that are zero but for rounding); new values and the
  BatchNorm statistics elementwise within rtol 1e-3, atol 1e-4 of JAX's;
- the ranks of one run hold bit-identical parameters, statistics and EMA;
- metrics: atol 1e-4 against JAX (as tests/test_torch_port_eval.py), 1e-6
  between the port's runs;
- BatchNorm against flax: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (TINY_NC, TINY_NM, TINY_SEG, narrow_semantic, port_model,
                               primed_tiny, random_variables)
from torch_port_dist_worker import EPOCHS, STEPS, build_trainer, run_ranks, step_result
from yolo_dual_tpu.data.loader import Loader as JLoader
from yolo_dual_tpu.engine import evaluate_segment as jax_evaluate_segment
from yolo_dual_tpu.engine import evaluate_semantic as jax_evaluate_semantic
from yolo_dual_tpu.losses import SemanticSegLoss as JSemanticSegLoss
from yolo_dual_tpu.losses.segment import ComputeSegmentLoss as JComputeSegmentLoss
from yolo_dual_tpu.models.model import SegmentationModel as JSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JSemanticSegModel
from yolo_dual_tpu.parallel import make_mesh as j_make_mesh
from yolo_dual_tpu.parallel import shard_batch as j_shard_batch
from yolo_dual_tpu.train import ModelEMA as JModelEMA
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu.train.trainer import classify_loss as jax_classify_loss
from yolo_dual_tpu_torch.data.loader import Loader
from yolo_dual_tpu_torch.engine.validator import evaluate_segment, evaluate_semantic
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.parallel import make_mesh, make_mesh_2d, pick_backend, shard_batch
from yolo_dual_tpu_torch.parallel.mesh import Mesh, rows_of
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

HYP = load_config(find_cfg("hyp.scratch-low.yaml"))
BS, M = 4, 4  # the global batch: 2 rows a rank
ELEMENT_TOL = dict(rtol=1e-3, atol=1e-4)


def assert_normwise_close(got, want, rtol, atol=1e-6, what=""):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    gap = float((got - want).abs().max()) if want.numel() else 0.0
    bound = rtol * float(want.abs().max() if want.numel() else 0) + atol
    assert gap <= bound, f"{what}: max gap {gap:.3g} > {bound:.3g}"


def jax_steps(jm, v, loss, task, batch, count):
    """JAX's train step on the global batch, on one device and on a mesh of 2
    CPU devices: {"one" | "mesh": state and EMA as port state_dicts, items, loss}."""
    out = {}
    b = {k: jnp.asarray(a) for k, a in batch.items()}
    for name, mesh in (("one", None), ("mesh", j_make_mesh(2))):
        tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS,
                               total_batch_size=BS)
        tr = JTrainer(jm, loss, tx, ema=JModelEMA(), task=task, mesh=mesh)
        s = tr.init_state(v)
        s = s.replace(opt_state=s.opt_state._replace(count=jnp.asarray(count, jnp.int32)))
        with jax.default_matmul_precision("highest"):
            s1, m = tr.make_train_step()(s, b if mesh is None else j_shard_batch(batch, mesh))
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        out[name] = {"state": state_dict_from_flax(to_np({"params": s1.params,
                                                          "batch_stats": s1.batch_stats})),
                     "ema": state_dict_from_flax(to_np(s1.ema["ema"])),
                     "items": np.asarray(m["items"]), "loss": float(m["loss"])}
    return out


def check_step(job, jm, v, jloss, task, tmp_path):
    """The port's step on 2 ranks against its one-process step and JAX's two."""
    start = {k: t.clone() for k, t in job["state_dict"].items()}
    ranks = run_ranks(job, tmp_path)
    tr, state = build_trainer(job)
    one = step_result(tr, state, job["batch"])
    want = jax_steps(jm, v, jloss, task, job["batch"], job.get("count", 0))
    for key in ("state", "ema"):  # DDP keeps the ranks in step
        assert all(torch.equal(ranks[0][key][k], ranks[1][key][k]) for k in start), key
    got = ranks[0]
    np.testing.assert_allclose(want["mesh"]["items"], want["one"]["items"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["items"], one["items"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["items"], want["mesh"]["items"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["mesh"]["loss"], rtol=1e-4)
    params = {k for k, g in got["grads"].items()}
    moved = 0
    for key in ("state", "ema"):
        for k, w in want["mesh"][key].items():
            g = got[key][k]
            if k.endswith("num_batches_tracked"):
                assert int(g) == 1, k
                continue
            if k in params:
                assert_normwise_close(g - start[k], w - start[k], 4e-3, what=f"{key} {k}")
                assert_normwise_close(g - start[k], one[key][k] - start[k], 1e-4,
                                      what=f"{key} {k} against one process")
                moved += not torch.equal(g, start[k])
            np.testing.assert_allclose(g.numpy(), w.numpy(), **ELEMENT_TOL, err_msg=f"{key} {k}")
    assert moved > len(params) // 2, moved
    return got


# --- one train step a task ---------------------------------------------------------------

def seg_batch(seed, imgsz=64):
    """A global batch of BS frames with 3, 1, 4 and 2 targets: the two ranks'
    rows (0, 2 and 1, 3) hold 7 and 3."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((BS, M, 5), np.float32)
    tmask = np.zeros((BS, M), bool)
    s = imgsz // 4
    masks = np.zeros((BS, s, s), np.float32)
    for i, n in enumerate((3, 1, 4, 2)):
        for j in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            targets[i, j] = [rng.integers(0, 80), cx, cy, w, h]
            tmask[i, j] = True
            masks[i, int((cy - h / 4) * s):int((cy + h / 4) * s) + 1,
                  int((cx - w / 4) * s):int((cx + w / 4) * s) + 1] = j + 1
    image = rng.integers(0, 256, (BS, imgsz, imgsz, 3), dtype=np.uint8)
    return {"image": image, "targets": targets, "tmask": tmask, "masks": masks}


def test_segment_step_on_two_ranks_matches_jax_mesh(tmp_path):
    """The nano yolov5n-seg with C3_DCNV3 rows 4, 6 and 8, past warmup."""
    d = load_config(find_cfg("yolov5n-seg.json"))
    for r in (4, 6, 8):
        d["backbone"][r][2] = "C3_DCNV3"
    jm = JSegmentationModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=0)
    kw = jm.spec.layers[-1].kw()
    jloss = JComputeSegmentLoss(kw["anchors"], kw["strides"], 80, 32, HYP, overlap=True)
    job = {"kind": "train", "task": "segment", "cfg": d, "state_dict": state_dict_from_flax(v),
           "batch": seg_batch(1), "batch_size": BS, "hyp": HYP, "count": 100}
    check_step(job, jm, v, jloss, "segment", tmp_path)


def test_remat_segment_step_on_two_ranks_matches_one_process(tmp_path):
    """--remat under --data-parallel: DDP wraps the rematerialised model, so the
    backward's recompute runs the model's forward and never DDP's. The 2 ranks'
    remat step of the nano yolov5n-seg with C3_DCNV3 rows against the port's
    one-process plain step, with the tolerances between the port's runs
    (JAX's own remat step raises, ROADMAP §C; the plain step is held against
    JAX's above)."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    d = load_config(find_cfg("yolov5n-seg.json"))
    for r in (4, 6, 8):
        d["backbone"][r][2] = "C3_DCNV3"
    sd = SegmentationModel(d, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    job = {"kind": "train", "task": "segment", "cfg": d, "state_dict": sd, "batch": seg_batch(2),
           "batch_size": BS, "hyp": HYP, "count": 100, "remat": True}
    ranks = run_ranks(job, tmp_path)
    tr, state = build_trainer({**job, "remat": False})
    one = step_result(tr, state, job["batch"])
    for key in ("state", "ema"):
        assert all(torch.equal(ranks[0][key][k], ranks[1][key][k]) for k in sd), key
    got = ranks[0]
    assert [r["ddp_forwards"] for r in ranks] == [1, 1]
    np.testing.assert_allclose(got["items"], one["items"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=2e-5)
    moved = 0
    for key in ("state", "ema"):
        for k, w in one[key].items():
            g = got[key][k]
            if k.endswith("num_batches_tracked"):
                assert int(g) == int(w) == 1, k  # the recompute leaves the count alone
            elif k in got["grads"]:
                assert_normwise_close(g - sd[k], w - sd[k], 1e-4, what=f"{key} {k}")
                moved += not torch.equal(g, sd[k])
            else:  # the running statistics, updated once
                assert_normwise_close(g, w, 1e-4, what=f"{key} {k}")
    assert moved > len(got["grads"]) // 2, moved


def test_semantic_ce_dice_step_on_two_ranks_matches_jax_mesh(tmp_path):
    """A narrow ResNet18 U-Net (widths / 8) with CE + 0.5 Dice, past warmup:
    the CE's pixel weights and the Dice's (image, class) terms span the ranks."""
    d = narrow_semantic("resnet18", 8)
    jm = JSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=3)
    rng = np.random.default_rng(4)
    mask = rng.integers(0, d["nc"], (BS, 64, 64)).astype(np.int32)
    colours = rng.integers(0, 256, (d["nc"], 3))
    image = np.clip(colours[mask] + rng.integers(-30, 31, (BS, 64, 64, 3)), 0, 255).astype(np.uint8)
    job = {"kind": "train", "task": "semantic", "cfg": d, "state_dict": state_dict_from_flax(v),
           "batch": {"image": image, "mask": mask}, "batch_size": BS, "hyp": HYP, "count": 100}
    got = check_step(job, jm, v, JSemanticSegLoss(d["nc"]), "semantic", tmp_path)
    assert got["items"][2] > 0  # the Dice term


def test_classify_step_on_two_ranks_matches_jax_mesh(tmp_path):
    """yolov5n-cls at 64 px, nc 10, label smoothing 0.1: the mean cross-entropy
    and the accuracy span the ranks."""
    from test_torch_port_classify import jax_classify_train
    jm = jax_classify_train().build_classifier("yolov5n.yaml", 10)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=9)
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-2, 2, (BS, 64, 64, 3)).astype(np.float32),
             "label": np.array([3, 7, 3, 1], np.int32)}
    job = {"kind": "train", "task": "classify", "cfg": "yolov5n.yaml", "nc": 10,
           "state_dict": state_dict_from_flax(v), "batch": batch, "batch_size": BS, "hyp": HYP,
           "count": 100}
    check_step(job, jm, v, lambda lg, lb: jax_classify_loss(lg, lb, 0.1), "classify", tmp_path)


# --- data-parallel evaluation ------------------------------------------------------------

def test_evaluate_segment_on_two_ranks_matches_jax_mesh_and_one_process(tmp_path):
    """The primed TINY_SEG on two self-labelled batches of 4, the last with 3
    real frames (ranks: 2 + 2 and 2 + 1)."""
    from test_torch_port_eval import self_labelled_batches
    jm, v = primed_tiny()
    batches = self_labelled_batches(v, True, False)
    batches[-1]["n_valid"] = np.int32(3)
    kw = dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM)
    want, want_maps, _ = jax_evaluate_segment(jm, v, batches, TINY_NC, mesh=j_make_mesh(2), **kw)
    one, one_maps, _ = evaluate_segment(port_model(v), batches, TINY_NC, device="cpu", **kw)
    ranks = run_ranks({"kind": "eval_segment", "cfg": TINY_SEG, "state_dict":
                       port_model(v).state_dict(), "batches": batches, "nc": TINY_NC, "kw": kw},
                      tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(one, np.float64), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["maps"], one_maps, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["mean"], np.asarray(want, np.float64), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ranks[0]["maps"], want_maps, rtol=0, atol=1e-4)
    assert one[2] > 0.05 and one[6] > 0.05, one


TINY_SEM = dict(  # JAX's tests/test_eval_dp.py model
    nc=3, compiler="semantic", activation="relu",
    backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]],
    head=[[-1, 1, "Upsample", [None, 4, "nearest"]], [-1, 1, "Conv", [3, 1, 1]]],
)


def test_evaluate_semantic_on_two_ranks_matches_jax_mesh_and_one_process(tmp_path):
    """7 frames in batches of 4 (the last 3 real: ranks 2 + 2 and 2 + 1): the
    summed confusion matrix and the global batches' val loss."""
    jm = JSemanticSegModel(TINY_SEM)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 32, 32, 3), seed=5)
    g = np.random.default_rng(5)
    batches = []
    for n_valid in (4, 3):
        img = g.uniform(0, 255, (4, 32, 32, 3)).astype(np.uint8)
        batches.append({"image": img, "mask": (img[..., 0].astype(np.int32)) % 3,
                        "n_valid": np.int32(n_valid)})
    want = jax_evaluate_semantic(jm, v, batches, 3, ignore_index=None,
                                 loss_fn=JSemanticSegLoss(3), mesh=j_make_mesh(2))
    sd = state_dict_from_flax(v)
    model = SemanticSegModel(TINY_SEM, device="cpu")
    model.load_state_dict(sd, strict=True)
    one = evaluate_semantic(model, batches, 3, ignore_index=None, loss_fn=SemanticSegLoss(3),
                            device="cpu")
    ranks = run_ranks({"kind": "eval_semantic", "cfg": TINY_SEM, "state_dict": sd,
                       "batches": batches, "nc": 3}, tmp_path)
    for r in ranks:
        assert r["miou"] == pytest.approx(one[0][0], abs=1e-6)
        assert r["loss"] == pytest.approx(one[0][1], rel=1e-5)
        np.testing.assert_allclose(r["iou"], one[1], atol=1e-6)
    assert ranks[0]["miou"] == pytest.approx(float(want[0][0]), abs=1e-4)
    assert ranks[0]["loss"] == pytest.approx(float(want[0][1]), rel=1e-4)
    np.testing.assert_allclose(ranks[0]["iou"], want[1], atol=1e-4)


# --- the Loader's shards, the batch split, the mesh ------------------------------------------

class Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i], np.int64)}


@pytest.mark.parametrize("n", [12, 11, 9])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_loader_shards_match_jax(n, shuffle):
    """Rank r's batches are JAX's Loader(num_shards=2, shard_index=r) batches;
    the ranks' k-th batches together are the one-process loader's k-th global
    batch. Where the last global batch leaves rank 1 no row (n = 9), its batch
    is padding with n_valid 0 (JAX's shard yields none)."""
    for epoch in (0, 1):
        whole = Loader(Items(n), batch_size=4, shuffle=shuffle, seed=3, prefetch=0)
        whole.set_epoch(epoch)
        glob = list(whole)
        per_rank = []
        for r in (0, 1):
            port = Loader(Items(n), batch_size=2, shuffle=shuffle, seed=3, prefetch=0,
                          num_shards=2, shard_index=r)
            jl = JLoader(Items(n), batch_size=2, shuffle=shuffle, seed=3, prefetch=0,
                         num_shards=2, shard_index=r)
            port.set_epoch(epoch)
            jl.set_epoch(epoch)
            got, want = list(port), list(jl)
            assert len(got) == len(glob) == len(port)
            real = [b for b in got if b["n_valid"] > 0]
            assert len(real) == len(want)
            for a, b in zip(real, want):
                np.testing.assert_array_equal(a["x"], b["x"])
                assert a["n_valid"] == b["n_valid"]
            assert all(b["x"].shape == (2, 1) for b in got)
            per_rank.append(got)
        for k, g in enumerate(glob):
            rows = sorted(int(x) for b in (per_rank[0][k], per_rank[1][k])
                          for x in b["x"][:b["n_valid"], 0])
            assert rows == sorted(int(x) for x in g["x"][:g["n_valid"], 0])
    assert (n == 9) == any(b["n_valid"] == 0 for b in per_rank[1])


def test_shard_batch_takes_strided_rows_and_counts_n_valid():
    batch = {"image": np.arange(5)[:, None], "n_valid": np.int32(3), "scalar": np.float32(2)}
    for rank, rows, n_valid in ((0, [0, 2, 4], 2), (1, [1, 3], 1)):
        mesh = Mesh(2, rank, torch.device("cpu"))
        got = shard_batch(batch, mesh)
        assert got["image"][:, 0].tolist() == rows and got["n_valid"] == n_valid
        assert got["scalar"] == 2 and rows_of(3, mesh) == n_valid


def test_collectives_on_two_ranks(tmp_path):
    """replicate sends rank 0's values; cross_replica_mean is JAX's pmean, its
    gradient summed over the ranks; inside `across`, global_sum adds the
    ranks' values and mean_share gives each rank its share of the mean over
    every rank's elements (rank 0 holds [0, 1], rank 1 [0, 1, 2])."""
    ranks = run_ranks({"kind": "collectives"}, tmp_path)
    assert [r["replicated"] for r in ranks] == [1.0, 1.0]
    assert [(r["mean"], r["grad"], r["sum"]) for r in ranks] == [(0.5, 1.0, 3)] * 2
    assert [r["share"] for r in ranks] == pytest.approx([0.2, 0.6])


def test_mesh_without_a_group_is_one_rank_and_2d_is_refused():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_mesh(2)
    with pytest.raises(ValueError, match=r"make_mesh_2d\(2, 2\): the process group has 1 ranks"):
        make_mesh_2d(2, 2)
    assert pick_backend(torch.device("cpu"), 2) == "gloo"
    if torch.cuda.device_count() < 2:  # ranks sharing one card cannot use NCCL
        assert pick_backend(torch.device("cuda"), 2) == "gloo"


def test_device_augmentation_of_a_ranks_rows_equals_jax_on_the_global_batch():
    """mosaic_warp_hsv draws nothing itself: on a rank's rows of a global batch
    of host draws (tiles, placements, warps, HSV gains, flips) it gives those
    rows of JAX's jitted call on the whole batch, within 1e-5 after /255. The
    draws themselves come from each rank's own generator (parallel/mesh.py:
    shard_loader), so they are not JAX's one-process draws."""
    import random
    from yolo_dual_tpu.kernels.augment import mosaic_warp_hsv as jax_mosaic_warp_hsv
    from yolo_dual_tpu_torch.data import augment
    from yolo_dual_tpu_torch.kernels.augment import mosaic_warp_hsv
    rng = np.random.default_rng(3)
    B, s = 4, 32
    tiles = rng.integers(0, 256, (B, 4, s, s, 3), dtype=np.uint8)
    dst = np.zeros((B, 4, 4), np.float32)
    for b in range(B):
        xc, yc = rng.integers(s // 2, 3 * s // 2, 2)
        dst[b] = [[max(xc - s, 0), max(yc - s, 0), xc, yc],
                  [xc, max(yc - s, 0), min(xc + s, 2 * s), yc],
                  [max(xc - s, 0), yc, xc, min(2 * s, yc + s)],
                  [xc, yc, min(xc + s, 2 * s), min(2 * s, yc + s)]]
    off = rng.uniform(-s, 0, (B, 4, 2)).round().astype(np.float32)
    inv = np.stack([np.linalg.inv(augment.sample_perspective_matrix(
        (2 * s, 2 * s), degrees=10, translate=0.1, scale=0.5, shear=5, perspective=1e-3,
        border=(-s // 2, -s // 2), rng=random.Random(b))[0]) for b in range(B)]).astype(np.float32)
    gains = (rng.uniform(-1, 1, (B, 3)) * [0.015, 0.7, 0.4] + 1).astype(np.float32)
    flips = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], bool)
    batch = dict(tiles=tiles, dst=dst, off=off, inv=inv, gains=gains, flips=flips)
    want = np.asarray(jax_mosaic_warp_hsv(*(jnp.asarray(a) for a in batch.values()), out_size=s))
    for r in (0, 1):
        rows = shard_batch(batch, Mesh(2, r, torch.device("cpu")))
        got = mosaic_warp_hsv(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rows.values()),
                              out_size=s)
        np.testing.assert_allclose(got.numpy(), want[r::2], rtol=0, atol=1e-5)


# --- the synchronised BatchNorm -----------------------------------------------------------

def test_sync_batchnorm_matches_flax_over_the_global_batch(tmp_path):
    """The port's BatchNorm2d synchronised over 2 ranks (eps 1e-3, momentum
    0.03) against flax's BatchNorm (momentum 0.97) on the whole batch: the
    output, the gradients of sum(output · w) with respect to the input, scale
    and bias (the ranks' parameter gradients summed, as DDP's average of
    2 · share gives), and the running statistics."""
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (6, 5, 7, 3)).astype(np.float32)      # NCHW, 3 rows a rank
    w = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 5).astype(np.float32), rng.normal(size=5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    xn, wn = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}}

    def f(xx, params):
        y, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return (y * wn).sum(), (y, upd)
    (_, (y, upd)), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(xn, v["params"])
    ranks = run_ranks({"kind": "sync_bn", "x": x, "w": w, "eps": 1e-3, "momentum": 0.03,
                       "scale": scale, "bias": bias}, tmp_path)
    tol = dict(rtol=1e-4, atol=1e-5)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["y"], np.asarray(y).transpose(0, 3, 1, 2)[r::2], **tol)
        np.testing.assert_allclose(got["dx"], np.asarray(dx).transpose(0, 3, 1, 2)[r::2], **tol)
        np.testing.assert_allclose(got["mean"], upd["batch_stats"]["mean"], **tol)
        np.testing.assert_allclose(got["var"], upd["batch_stats"]["var"], **tol)
    np.testing.assert_allclose(ranks[0]["dscale"] + ranks[1]["dscale"], dp["scale"], **tol)
    np.testing.assert_allclose(ranks[0]["dbias"] + ranks[1]["dbias"], dp["bias"], **tol)
