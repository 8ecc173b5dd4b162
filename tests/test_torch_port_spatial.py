"""Spatial partitioning (parallel/spatial.py, parallel/mesh.py:make_mesh_2d)
against the JAX package's data x space mesh and the port's one process.

One bundle of jobs runs on 4 gloo ranks (tests/torch_port_dist_worker.py),
started once for the module and joined when a test first reads it, while
this process computes the references (JAX's step of the nano DCNv3 model in
a process of its own):
- the halo ops (conv k1/k3/k6, s1/s2, a dilated conv, the k5 max-pool, a
  gathered synchronised BatchNorm) on a 2 x 2 and a 1 x 4 mesh against the
  one-process op on the whole map, float64, within 1e-6 of the largest value
  (the BatchNorm's statistics count a gathered map's rows sp times in every
  sum and in the count, so they are the one-process statistics);
- 3 SGD steps of TINY_SEG on dp 2 x sp 2 against JAX's
  Trainer(mesh=make_mesh_2d(2, 2)) on conftest's virtual CPU devices, JAX's
  one-device steps and the port's one process (tests/test_torch_port_dist.py's
  tolerances: loss rtol 1e-4 against JAX, updates normwise 4e-3 against JAX
  and 1e-4 between the port's runs);
- a step of the narrow ResNet18 U-Net (semantic, its gathered layers) against
  JAX's 2-D step; a step of the nano DCNv3 model against JAX's one-device
  step, and in float64 against the port's one process;
- evaluate_segment on the 2-D mesh against the port's one process;
- yolov5s-seg-dcnv3 at full width: which layers ran on bands and which
  gathered, and its raw outputs against one process.
The DCNv3 sampling's plain versions on a band (`row0`) run in this process.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (TINY_NC, TINY_NM, TINY_SEG, narrow_semantic, orbax_fixture_cfg,
                               port_model, primed_tiny, random_variables)
from torch_port_dist_worker import EPOCHS, STEPS, build_trainer, join_ranks, start_ranks
from yolo_dual_tpu.losses import SemanticSegLoss as JSemanticSegLoss
from yolo_dual_tpu.losses.segment import ComputeSegmentLoss as JComputeSegmentLoss
from yolo_dual_tpu.models.model import SegmentationModel as JSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JSemanticSegModel
from yolo_dual_tpu.parallel import shard_batch as j_shard_batch
from yolo_dual_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from yolo_dual_tpu.train import ModelEMA as JModelEMA
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu_torch.engine.validator import evaluate_segment
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.kernels.dcn_sampling import (dcnv3_core, dcnv3_core_bwd, dcnv3_plan,
                                                      dcnv3_window_escapes)
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.nn.common import max_pool_same
from yolo_dual_tpu_torch.parallel import spatial
from yolo_dual_tpu_torch.parallel.mesh import Mesh, make_mesh_2d, shard_batch
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

HYP = load_config(find_cfg("hyp.scratch-low.yaml"))
BS = 4  # the global batch: 2 rows a data shard
MESH = (2, 2)
CONVS = ((1, 1, 0, 1), (3, 1, 1, 1), (3, 2, 1, 1), (6, 2, 2, 1), (3, 1, 2, 2))  # k, s, p, d
POOLS = (5,)
OP_TOL = 1e-6


def assert_normwise_close(got, want, rtol, atol=1e-6, what=""):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    gap = float((got - want).abs().max()) if want.numel() else 0.0
    bound = rtol * float(want.abs().max() if want.numel() else 0) + atol
    assert gap <= bound, f"{what}: max gap {gap:.3g} > {bound:.3g}"


def tiny_batch(seed, nc=TINY_NC, imgsz=64):
    """BS frames with 3, 1, 4 and 2 targets of `nc` classes and their overlap
    mask planes at imgsz / 4."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((BS, 4, 5), np.float32)
    tmask = np.zeros((BS, 4), bool)
    s = imgsz // 4
    masks = np.zeros((BS, s, s), np.float32)
    for i, n in enumerate((3, 1, 4, 2)):
        for j in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            targets[i, j] = [rng.integers(0, nc), cx, cy, w, h]
            tmask[i, j] = True
            masks[i, int((cy - h / 4) * s):int((cy + h / 4) * s) + 1,
                  int((cx - w / 4) * s):int((cx + w / 4) * s) + 1] = j + 1
    image = rng.integers(0, 256, (BS, imgsz, imgsz, 3), dtype=np.uint8)
    return {"image": image, "targets": targets, "tmask": tmask, "masks": masks}


def ops_inputs():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(BS, 4, 16, 12))
    convs = {}
    for k, s, p, d in CONVS:
        conv = torch.nn.Conv2d(4, 3, k, s, p, d, dtype=torch.float64)
        torch.nn.init.normal_(conv.weight, generator=torch.Generator().manual_seed(k + s + d))
        convs[f"conv k{k} s{s} p{p} d{d}"] = conv
    outs = {name: conv(torch.from_numpy(x)) for name, conv in convs.items()}
    outs.update({f"pool k{k}": max_pool_same(torch.from_numpy(x), k) for k in POOLS})
    outs["gathered bn"] = torch.from_numpy(x)
    w = {name: rng.normal(size=tuple(y.shape)) for name, y in outs.items()}
    return {"x": x, "w": w, "convs": CONVS, "pools": POOLS, "bn_scale": rng.uniform(0.5, 2, 4),
            "conv_weights": {n: {k: v.detach().numpy() for k, v in c.state_dict().items()}
                             for n, c in convs.items()}}, convs


# --- the jobs, their inputs and the ranks -----------------------------------------------

def tiny_job():
    jm = JSegmentationModel(TINY_SEG)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=0)
    return jm, v, {"kind": "train", "task": "segment", "cfg": TINY_SEG,
                   "state_dict": state_dict_from_flax(v), "batch": tiny_batch(1),
                   "batch_size": BS, "hyp": HYP, "count": 100, "steps": 3, "mesh2d": MESH}


def semantic_job():
    d = narrow_semantic("resnet18", 8)
    jm = JSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=3)
    rng = np.random.default_rng(4)
    mask = rng.integers(0, d["nc"], (BS, 64, 64)).astype(np.int32)
    colours = rng.integers(0, 256, (d["nc"], 3))
    image = np.clip(colours[mask] + rng.integers(-30, 31, (BS, 64, 64, 3)), 0, 255).astype(np.uint8)
    return jm, v, {"kind": "train", "task": "semantic", "cfg": d,
                   "state_dict": state_dict_from_flax(v), "batch": {"image": image, "mask": mask},
                   "batch_size": BS, "hyp": HYP, "count": 100, "mesh2d": MESH}


def dcnv3_job():
    """The nano DCNv3 model's step in float32 and, on the same batch scaled to
    [0, 1], in float64."""
    d = orbax_fixture_cfg()
    jm = JSegmentationModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, 64, 64, 3), seed=2)
    job = {"kind": "train", "task": "segment", "cfg": d, "state_dict": state_dict_from_flax(v),
           "batch": tiny_batch(2, nc=80), "batch_size": BS, "hyp": HYP, "count": 100,
           "mesh2d": MESH}
    b = job["batch"]
    job64 = {**job, "dtype": torch.float64,
             "batch": {**b, "image": b["image"] / 255.0, "targets": b["targets"].astype(np.float64),
                       "masks": b["masks"].astype(np.float64)}}
    return jm, v, job, job64


def classify_job():
    from yolo_dual_tpu_torch.classify.train import build_classifier
    model = build_classifier("yolov5n.yaml", 10, device="cpu",
                             generator=torch.Generator().manual_seed(9))
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(-2, 2, (BS, 64, 64, 3)).astype(np.float32),
             "label": np.array([3, 7, 3, 1], np.int32)}
    return {"kind": "train", "task": "classify", "cfg": "yolov5n.yaml", "nc": 10,
            "state_dict": model.state_dict(), "batch": batch, "batch_size": BS, "hyp": HYP,
            "count": 100, "mesh2d": MESH}


def eval_job():
    from test_torch_port_eval import self_labelled_batches
    jm, v = primed_tiny()
    batches = self_labelled_batches(v, True, False)
    batches[-1]["n_valid"] = np.int32(3)
    return v, {"kind": "eval_segment", "cfg": TINY_SEG, "state_dict": port_model(v).state_dict(),
               "batches": batches, "nc": TINY_NC,
               "kw": dict(conf_thres=0.001, iou_thres=0.6, nm=TINY_NM), "mesh2d": MESH}


FORWARD_X = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


class Bundle:
    """The module's ranks: started once, joined at the first read."""

    def __init__(self, tmp_path):
        self.ops, self.convs = ops_inputs()
        self.tiny = tiny_job()
        self.semantic = semantic_job()
        self.dcnv3 = dcnv3_job()
        self.eval = eval_job()
        self.remat = {**self.tiny[2], "steps": 1, "remat": True}
        self.classify = classify_job()
        jobs = [{**self.ops, "kind": "spatial_ops", "mesh2d": MESH},
                {**self.ops, "kind": "spatial_ops", "mesh2d": (1, 4)},
                self.tiny[2], self.semantic[2], self.dcnv3[2], self.dcnv3[3], self.eval[1],
                self.remat, self.classify,
                {"kind": "band_forward", "cfg": "yolov5s-seg-dcnv3.json", "x": FORWARD_X,
                 "mesh2d": MESH},
                {"kind": "refusals"}]
        self.names = ["ops sp2", "ops sp4", "tiny", "semantic", "dcnv3", "dcnv3 f64", "eval",
                      "remat", "classify", "forward", "refusals"]
        self.handle = start_ranks({"kind": "bundle", "jobs": jobs}, tmp_path, world=4,
                                  timeout=300)
        self._results = None
        # JAX's step of the nano DCNv3 model, the file's longest compile, runs in a process of
        # its own beside the ranks and this process's references
        self.pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        jm, v, job, _ = self.dcnv3
        self.dcnv3_jax = self.pool.submit(dcnv3_jax_step, job["cfg"], v, job["batch"])

    def __getitem__(self, name):
        if self._results is None:
            self._results = join_ranks(self.handle)
        return [r[self.names.index(name)] for r in self._results]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test, so the ranks run while this
    process computes the references."""
    bundle = Bundle(tmp_path_factory.mktemp("spatial"))
    yield bundle
    bundle.pool.shutdown(cancel_futures=True)


# --- the train steps against JAX (first: the ranks run meanwhile) ------------------------

def jax_run(jm, v, loss, task, batch, mesh, steps, count):
    """JAX's `steps` train steps on the global batch, on one device (mesh None)
    or the 2-D mesh: the last state and EMA as port state_dicts, every
    step's loss and the last items."""
    tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=EPOCHS, steps_per_epoch=STEPS,
                           total_batch_size=BS)
    tr = JTrainer(jm, loss, tx, ema=JModelEMA(), task=task, mesh=mesh)
    s = tr.init_state(v)
    s = s.replace(opt_state=s.opt_state._replace(count=jnp.asarray(count, jnp.int32)))
    b = {k: jnp.asarray(a) for k, a in batch.items()}
    if mesh is not None:
        b = j_shard_batch(b, mesh)
    step, losses = tr.make_train_step(donate=False), []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"state": state_dict_from_flax(to_np({"params": s.params,
                                                 "batch_stats": s.batch_stats})),
            "ema": state_dict_from_flax(to_np(s.ema["ema"])), "losses": losses,
            "items": np.asarray(m["items"])}


def dcnv3_jax_step(cfg, v, batch):
    """JAX's one-device step of the nano DCNv3 model (`cfg`, variables `v`) on
    `batch`: jax_run's result."""
    jax.config.update("jax_platforms", "cpu")  # as conftest.py, which this process does not run
    jm = JSegmentationModel(cfg)
    head = jm.spec.layers[-1].kw()
    loss = JComputeSegmentLoss(head["anchors"], head["strides"], 80, 32, HYP, overlap=True)
    return jax_run(jm, v, loss, "segment", batch, None, 1, 100)


def port_one(job):
    """The port's one process on the global batch: the job's steps."""
    from torch_port_dist_worker import step_result
    tr, state = build_trainer(job)
    losses = []
    for _ in range(job.get("steps", 1)):
        out = step_result(tr, state, job["batch"])
        losses.append(out["loss"])
    return {**out, "losses": losses}


def check_2d_step(got_ranks, job, one, jax_refs, rtol=1e-4):
    """The 2 x 2 ranks against each other, the port's one process `one` (None:
    not held) within `rtol` and each JAX reference of `jax_refs` (name ->
    jax_run's result)."""
    start = job["state_dict"]
    for r in got_ranks[1:]:  # DDP keeps every rank in step
        for key in ("state", "ema"):
            assert all(torch.equal(r[key][k], got_ranks[0][key][k]) for k in start), key
    got = got_ranks[0]
    if one is not None:
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=rtol)
        np.testing.assert_allclose(got["items"], one["items"], rtol=rtol, atol=1e-6)
    for name, want in jax_refs.items():
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got["items"], want["items"], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    params = set(got["grads"])
    for k, g in got["grads"].items():  # summed over space, averaged over data: the global one
        if g is not None and one is not None:
            assert_normwise_close(g, one["grads"][k], rtol, what=f"gradient {k}")
    moved = 0
    for key in ("state", "ema"):
        for k, g in got[key].items():
            if k.endswith("num_batches_tracked"):
                assert int(g) == job.get("steps", 1), k
                continue
            if k in params:
                if one is not None:
                    assert_normwise_close(g - start[k], one[key][k] - start[k], rtol,
                                          what=f"{key} {k} against one process")
                for name, want in jax_refs.items():
                    assert_normwise_close(g - start[k], want[key][k] - start[k], 4e-3,
                                          what=f"{key} {k} against JAX {name}")
                moved += not torch.equal(g, start[k])
            else:  # BatchNorm statistics
                if one is not None:
                    assert_normwise_close(g, one[key][k], rtol,
                                          what=f"{key} {k} against one process")
                for name, want in jax_refs.items():
                    np.testing.assert_allclose(g.numpy(), want[key][k].numpy(), rtol=1e-3,
                                               atol=1e-4, err_msg=f"{key} {k} {name}")
    assert moved > len(params) // 2, moved


def test_tiny_seg_steps_on_a_2d_mesh_match_jax_2d_and_one_device(ranks):
    """TINY_SEG, 3 SGD steps past warmup on hyp.scratch-low, dp 2 x sp 2:
    JAX's make_mesh_2d(2, 2) step and its one-device step give the same
    losses (as JAX's tests/test_trainer.py holds), and the port's ranks
    match both and the port's one process."""
    jm, v, job = ranks.tiny
    head = jm.spec.layers[-1].kw()
    loss = JComputeSegmentLoss(head["anchors"], head["strides"], TINY_NC, TINY_NM, HYP,
                               overlap=True)
    refs = {"2d": jax_run(jm, v, loss, "segment", job["batch"], j_make_mesh_2d(*MESH), 3, 100),
            "one device": jax_run(jm, v, loss, "segment", job["batch"], None, 3, 100)}
    np.testing.assert_allclose(refs["2d"]["losses"], refs["one device"]["losses"], rtol=2e-4)
    check_2d_step(ranks["tiny"], job, port_one(job), refs)


def test_semantic_step_on_a_2d_mesh_matches_jax_2d(ranks):
    """The narrow ResNet18 U-Net (widths / 8), CE + Dice: every layer but the
    aligning Concat's inputs runs gathered (stem, residual stages, head), so
    this holds the gathered path and the synchronised BatchNorm's sp-fold
    count against JAX's 2-D step."""
    jm, v, job = ranks.semantic
    ref = jax_run(jm, v, JSemanticSegLoss(job["cfg"]["nc"]), "semantic", job["batch"],
                  j_make_mesh_2d(*MESH), 1, 100)
    check_2d_step(ranks["semantic"], job, port_one(job), {"2d": ref})
    assert ranks["semantic"][0]["items"][2] > 0  # the Dice term


# --- the DCNv3 nano model -----------------------------------------------------------------

def test_dcnv3_nano_step_on_a_2d_mesh_matches_one_process(ranks):
    """The nano DCNv3 model (orbax_fixture_cfg, C3_DCNV3 rows 4, 6 and 8, random
    offset and mask heads): its DCNv3 sampling gathers input_proj's output and
    samples the band's rows at their global rows (row0), K3's dx over the
    whole map summed over the space group.

    In float32 the ranks' step is held against JAX's one-device step. JAX's
    2-D step of this model also runs on the CPU, but its compile takes longer
    than this file's budget; JAX's 2-D and one-device steps agree on TINY_SEG
    above. Against the port's one process the step is held in float64 within
    1e-9: in float32 either run lies up to ~1.8e-4 of a tensor's largest
    gradient from float64 (the random offsets put samples near cell edges,
    where rounding moves a bilinear weight), above the 1e-4 the port's
    float32 runs are held to elsewhere, while float64 puts the two runs
    within ~5e-13."""
    jm, v, job, job64 = ranks.dcnv3
    check_2d_step(ranks["dcnv3"], job, None, {"one device": ranks.dcnv3_jax.result()})
    check_2d_step(ranks["dcnv3 f64"], job64, port_one(job64), {}, rtol=1e-9)


def test_remat_step_on_a_2d_mesh_matches_one_process(ranks):
    """--remat inside the 2-D mesh: the backward's recompute runs on the bands
    again (its halo exchanges and gathers in the backward), once through DDP;
    TINY_SEG's step against the port's plain one-process step (JAX's own
    remat step raises, ROADMAP §C; the plain 2-D step is held against JAX's
    above)."""
    job = ranks.remat
    assert [r["ddp_forwards"] for r in ranks["remat"]] == [1] * 4
    check_2d_step(ranks["remat"], job, port_one({**job, "remat": False}), {})


def test_classify_step_on_a_2d_mesh_matches_one_process(ranks):
    """yolov5n-cls at 64 px: Conv, C3 and SPPF on bands, the Classify head
    gathered; its logits have no rows, so each space rank keeps a 1/sp share
    of their gradient (spatial.share_grad)."""
    job = ranks.classify
    check_2d_step(ranks["classify"], job, port_one(job), {})


# --- the DCNv3 sampling on a band, one process ---------------------------------------------

def dcnv3_inputs(stride, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, g, gc, k = 2, 16, 12, 2, 4, 3
    ho, wo = (h + 2 - k) // stride + 1, (w + 2 - k) // stride + 1
    x = torch.from_numpy(rng.normal(size=(b, h, w, g * gc)).astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 2, (b, ho, wo, g * k * k * 2)).astype(np.float32))
    mask = torch.from_numpy(rng.normal(size=(b, ho, wo, g, k * k))).softmax(-1) \
        .reshape(b, ho, wo, g * k * k).float()
    gout = torch.from_numpy(rng.normal(size=(b, ho, wo, g * gc)).astype(np.float32))
    return x, off, mask, gout, (k, stride, 1, 1, g, gc, 1.0)


@pytest.mark.parametrize("stride,band", [(1, 0), (1, 1), (1, 3), (2, 0), (2, 1)])
def test_dcnv3_plain_versions_on_a_band_equal_the_whole_maps_rows(stride, band):
    """Kernel 3: the band of 4 output rows from row0 = 4·band, sampled in the
    whole x, gives the whole map's output rows, doffset and dmask bit for
    bit, and dx equal to the whole map's for the output gradient of the
    band's rows alone."""
    x, off, mask, gout, cfg = dcnv3_inputs(stride)
    r0, h = 4 * band, 4
    rows = slice(r0, r0 + h)
    whole = dcnv3_core(x, off, mask, *cfg)
    got = dcnv3_core(x, off[:, rows], mask[:, rows], *cfg, r0)
    assert torch.equal(got, whole[:, rows])
    band_gout = torch.zeros_like(gout)
    band_gout[:, rows] = gout[:, rows]
    dx, doff, dmask = dcnv3_core_bwd(x, off, mask, band_gout, *cfg)
    gdx, gdoff, gdmask = dcnv3_core_bwd(x, off[:, rows], mask[:, rows], gout[:, rows], *cfg, r0)
    assert torch.equal(gdoff, doff[:, rows]) and torch.equal(gdmask, dmask[:, rows])
    assert gdx.shape == x.shape and torch.equal(gdx, dx)
    # row0 moves each block's shared-memory window with its tile: offsets of 0 keep every
    # sample of the band inside its window, as on the whole map; the band's rows given as
    # offsets of row0·stride instead would move samples out of it (all of them, once row0·stride
    # exceeds the window's rows)
    zero = torch.zeros_like(off[:, rows])
    plan = dcnv3_plan(2, h, off.shape[2], 2, 4, *cfg[:4], 1.0, False)
    assert dcnv3_window_escapes(zero, 16, 12, *cfg[:5], 1.0, plan, r0) == 0.0
    if r0:
        shifted = zero.clone()
        shifted[..., 1::2] = r0 * stride  # (dx, dy) pairs
        assert dcnv3_window_escapes(shifted, 16, 12, *cfg[:5], 1.0, plan) >= 0.5


def test_dcnv3_plain_band_gradients_sum_to_the_whole_maps():
    """The bands' dx over the whole map, summed over the bands (the gather's
    backward), give the whole map's dx."""
    x, off, mask, gout, cfg = dcnv3_inputs(1, seed=1)
    dx = dcnv3_core_bwd(x, off, mask, gout, *cfg)[0]
    total = sum(dcnv3_core_bwd(x, off[:, r:r + 8], mask[:, r:r + 8], gout[:, r:r + 8], *cfg, r)[0]
                for r in (0, 8))
    assert_normwise_close(total, dx, 1e-6, 0.0, "dx")


# --- the halo ops -------------------------------------------------------------------------

@pytest.mark.parametrize("name,sp", [("ops sp2", 2), ("ops sp4", 4)])
def test_halo_ops_on_bands_equal_the_whole_maps_op(ranks, name, sp):
    """Each op's output bands and input gradient bands against the one-process
    op on the whole map, within OP_TOL of the largest value; the parameters'
    gradients summed over the ranks against the whole map's."""
    x = torch.from_numpy(ranks.ops["x"]).requires_grad_(True)
    got = ranks[name]
    dp = 4 // sp  # the 4 ranks' data shards
    for op in got[0]:
        params = ()
        xx = x.detach().clone().requires_grad_(True)
        if op.startswith("conv"):
            conv = ranks.convs[op]
            conv.zero_grad()
            y, params = conv(xx), (conv.weight, conv.bias)
        elif op.startswith("pool"):
            y = max_pool_same(xx, int(op.split("k")[1]))
        else:
            from yolo_dual_tpu_torch.nn.common import BatchNorm2d
            bn = BatchNorm2d(4, dtype=torch.float64).train()
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(ranks.ops["bn_scale"]))
            y, params = bn(xx), (bn.weight, bn.bias)
        (y * torch.from_numpy(ranks.ops["w"][op])).sum().backward()
        for r, res in enumerate(got):
            d, s = divmod(r, sp)
            h, hx = y.shape[2] // sp, x.shape[2] // sp
            want_y = y[d::dp, :, s * h:(s + 1) * h].detach().numpy()
            want_dx = xx.grad[d::dp, :, s * hx:(s + 1) * hx].numpy()
            np.testing.assert_allclose(res[op]["y"], want_y, rtol=0,
                                       atol=OP_TOL * abs(want_y).max(), err_msg=f"{op} rank {r}")
            np.testing.assert_allclose(res[op]["dx"], want_dx, rtol=0,
                                       atol=OP_TOL * abs(want_dx).max(), err_msg=f"{op} rank {r}")
        for j, p in enumerate(params):
            total = sum(res[op]["dparams"][j] for res in got)
            np.testing.assert_allclose(total, p.grad.numpy(), rtol=0,
                                       atol=OP_TOL * abs(p.grad.numpy()).max(), err_msg=op)
        if op == "gathered bn":
            for res in got:
                for a, b in zip(res[op]["stats"], (bn.running_mean, bn.running_var)):
                    np.testing.assert_allclose(a, b.numpy(), rtol=1e-10, atol=1e-12)


# --- evaluation, the counts, the refusals ------------------------------------------------

def test_evaluate_segment_on_a_2d_mesh_matches_one_process(ranks):
    """The primed TINY_SEG on two self-labelled batches of 4, the last with 3
    real frames: every rank returns the one-process metrics."""
    v, job = ranks.eval
    one, one_maps, _ = evaluate_segment(port_model(v), job["batches"], TINY_NC, device="cpu",
                                        **job["kw"])
    for r in ranks["eval"]:
        np.testing.assert_allclose(r["mean"], np.asarray(one, np.float64), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["maps"], one_maps, rtol=0, atol=1e-6)
    assert one[2] > 0.05 and one[6] > 0.05, one


def test_yolov5s_seg_dcnv3_runs_on_bands_and_gathers_only_dcnv3_inputs_and_the_head(ranks):
    """Full width at 64 px on dp 2 x sp 2 (bands of 1 row at stride 32, so
    SPPF's 2-row halo spans two ranks): every Conv with a kernel above 1
    exchanged its halo once (20: the stem, six strided convs, five
    bottlenecks' 3x3s, six DCNv3 dw_convs, Proto's two), SPPF's three pools
    theirs, the six DCNv3 samplings and the head's four outputs gathered,
    nothing else; the raw outputs equal a one-process train-mode forward's."""
    got = ranks["forward"]
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu",
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        levels, protos = model.train()(torch.from_numpy(FORWARD_X).permute(0, 3, 1, 2)
                                       .contiguous(), decode=False)
    for r, res in enumerate(got):
        assert res["counts"] == {"halo Conv": res["halo_convs"], "halo max_pool": 3,
                                 "gather dcnv3": 6, "gather head": 4}, res["counts"]
        d = r // MESH[1]
        for a, b in zip(res["levels"] + [res["protos"]], list(levels) + [protos]):
            want = b[d::MESH[0]].numpy()
            np.testing.assert_allclose(a, want, rtol=0, atol=1e-4 * abs(want).max())
    assert got[0]["halo_convs"] == 20


def test_refusals():
    """make_mesh_2d on a world that is not dp·sp (one process, and 3 x 1 on
    4 ranks), an input height that sp x the largest stride does not divide,
    and a batch whose rows do not split into bands."""
    with pytest.raises(ValueError, match="process group has 1 ranks, not dp·sp = 4"):
        make_mesh_2d(2, 2)
    mesh = Mesh(1, 0, torch.device("cpu"), sp=2)  # checks run before any exchange
    model = SegmentationModel(TINY_SEG, device="cpu")
    with spatial.spatial(mesh), pytest.raises(ValueError, match=r"H = 48 .* 2 x 16 = 32"):
        model.train()(torch.zeros(1, 3, 24, 64), decode=False)
    with pytest.raises(ValueError, match="7 rows does not split into 2 bands"):
        shard_batch({"image": np.zeros((2, 7, 8, 3))}, mesh)


def test_a_world_that_is_not_dp_sp_is_refused_on_the_ranks(ranks):
    assert all("has 4 ranks, not dp·sp = 3" in r["world"] for r in ranks["refusals"])
