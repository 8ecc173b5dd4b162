"""Per-layer rematerialisation (`remat_layers`, JAX's GraphModel.remat_layers)
in the port: the train step of a model that recomputes some of its rows in
the backward against the plain step and against JAX's step with the same
`remat_layers`.

Models: yolov5n-seg, the nano DCNv3 model of tests/test_torch_port_dcn.py
(yolov5n-seg with rows 4, 6 and 8 made C3_DCNV3; row 4 repeats its module
twice and row 6 three times) and the narrow ResNet18 U-Net of the semantic
tests (widths / 8; its SegmentHead takes three maps). Settings: True, JAX's
"early" rows (0, 1, 2, 3, 4) and one row.

- The port's step (Trainer.train_step: SGD, the EMA) in float64 equals its
  plain step bit for bit: loss items, gradients, parameters, EMA and the
  BatchNorm statistics, updated once (num_batches_tracked 1). Each wrapped
  module runs twice (its recompute), every other once; eval forwards are
  the plain model's, run once. The same under Trainer(remat=True) around
  it (nested checkpoints) and under torch.autocast bfloat16.
- In float32 against JAX's jitted value_and_grad of Trainer._forward_loss
  with the same remat_layers (yolov5n-seg's "early" rows, JAX's
  tools/bench_remat.py set; True on the other two; a JAX compile each),
  from the same weights: loss items within rtol
  1e-4, every gradient within 1e-3 of its tensor's largest magnitude plus
  1e-5 of the model's largest gradient (a bias that a BatchNorm follows has
  a gradient of 0 but for rounding) and the new running statistics within
  atol 1e-4 (the sums run in other orders; tests/test_torch_port_train_flags.py's
  remat bounds).
- On 2 gloo ranks under DDP (find_unused_parameters) and on a dp 1 x sp 2
  mesh, where the recompute runs on the rank's band and the semantic model's
  layers run gathered, against the port's one-process plain step: the nano
  DCNv3 model in float64 within 1e-9, the semantic model (its batch uint8,
  so float32: the mesh bands NHWC images) within 1e-4
  (tests/test_torch_port_spatial.py's bound), each tensor against its largest
  magnitude plus 1e-6 of the model's largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import narrow_semantic, random_variables
from torch_port_dist_worker import build_trainer, join_ranks, start_ranks, step_result
from yolo_dual_tpu.losses import SemanticSegLoss as JSemanticSegLoss
from yolo_dual_tpu.losses.segment import ComputeSegmentLoss as JComputeSegmentLoss
from yolo_dual_tpu.models.model import SegmentationModel as JSegmentationModel
from yolo_dual_tpu.models.model import SemanticSegModel as JSemanticSegModel
from yolo_dual_tpu.train import Trainer as JTrainer
from yolo_dual_tpu.train import smart_optimizer as j_smart_optimizer
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.models.model import remat_rows
from yolo_dual_tpu_torch.nn.dcn import DCNv3
from yolo_dual_tpu_torch.utils.general import find_cfg, load_config

HYP = load_config(find_cfg("hyp.scratch-low.yaml"))
BS, IMGSZ = 2, 64
GRAD_TOL, GRAD_FLOOR, ITEM_TOL, STAT_TOL = 1e-3, 1e-5, 1e-4, 1e-4  # float32 against JAX
SETTINGS = {"true": True, "early": (0, 1, 2, 3, 4), "one_row": None}  # None: ONE_ROW's
ONE_ROW = {"yolov5n-seg": (6,), "nano_dcnv3": (4,), "resnet18": (2,)}


def nano_dcnv3_cfg():
    d = load_config(find_cfg("yolov5n-seg.json"))
    for r in (4, 6, 8):
        d["backbone"][r][2] = "C3_DCNV3"
    return d


def seg_batch(seed=1):
    rng = np.random.default_rng(seed)
    targets = np.zeros((BS, 4, 5), np.float32)
    tmask = np.zeros((BS, 4), bool)
    s = IMGSZ // 4
    masks = np.zeros((BS, s, s), np.float32)
    for i, n in enumerate((3, 2)):
        for j in range(n):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            targets[i, j] = [rng.integers(0, 80), cx, cy, w, h]
            tmask[i, j] = True
            masks[i, int((cy - h / 4) * s):int((cy + h / 4) * s) + 1,
                  int((cx - w / 4) * s):int((cx + w / 4) * s) + 1] = j + 1
    return {"image": rng.integers(0, 256, (BS, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "targets": targets, "tmask": tmask, "masks": masks}


def sem_batch(nc, seed=4):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, nc, (BS, IMGSZ, IMGSZ)).astype(np.int32)
    colours = rng.integers(0, 256, (nc, 3))
    image = np.clip(colours[mask] + rng.integers(-30, 31, (BS, IMGSZ, IMGSZ, 3)), 0, 255)
    return {"image": image.astype(np.uint8), "mask": mask}


def case(name):
    """(task, config dict, JAX model class, seeded JAX variables, batch)."""
    if name == "resnet18":
        d = narrow_semantic("resnet18", 8)
        jcls, task, batch = JSemanticSegModel, "semantic", sem_batch(d["nc"])
    else:
        d = nano_dcnv3_cfg() if name == "nano_dcnv3" else load_config(find_cfg("yolov5n-seg.json"))
        jcls, task, batch = JSegmentationModel, "segment", seg_batch()
    jm = jcls(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=3)
    return task, d, jcls, v, batch


CASES = {name: case(name) for name in ONE_ROW}


def dead_rows_job():
    """The narrow yolov5_seg (widths / 16), whose head rows 12-20 feed no
    output, with remat_layers=True, in float64: under DDP with
    find_unused_parameters their parameters are the unused ones."""
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    d = narrow_semantic("yolov5_seg", 16)
    model = SemanticSegModel(d, device="cpu", generator=torch.Generator().manual_seed(5))
    return {"kind": "train", "task": "semantic", "cfg": d, "state_dict": model.state_dict(),
            "batch": sem_batch(d["nc"], seed=6), "batch_size": BS, "hyp": HYP, "count": 100,
            "remat_layers": True, "dtype": torch.float64}


def job_of(name, **kw):
    task, d, _, v, batch = CASES[name]
    return {"kind": "train", "task": task, "cfg": d, "state_dict": state_dict_from_flax(v),
            "batch": batch, "batch_size": BS, "hyp": HYP, "count": 100, **kw}


def float64_batch(task, batch):
    """`batch` as the float64 step takes it: a segment image NHWC in [0, 1],
    a semantic one NCHW (the device route's layout)."""
    image = batch["image"] / 255.0
    if task == "semantic":
        return {**batch, "image": np.ascontiguousarray(image.transpose(0, 3, 1, 2))}
    return {**batch, "image": image, "targets": batch["targets"].astype(np.float64),
            "masks": batch["masks"].astype(np.float64)}


def setting(name, key):
    return ONE_ROW[name] if SETTINGS[key] is None else SETTINGS[key]


def counted_step(job, batch=None, **trainer_kw):
    """One train step of `job` (build_trainer): step_result, and how often each
    row's modules started a forward (a repeated row's copies each)."""
    tr, state = build_trainer(job)
    for k, v in trainer_kw.items():
        setattr(tr, k, v)
    calls = {}
    for i, mod in enumerate(tr.model.model):
        for m in (mod if isinstance(mod, torch.nn.Sequential) else [mod]):
            m.register_forward_pre_hook(lambda *a, i=i: calls.__setitem__(i, calls.get(i, 0) + 1))
    dcn = [0]
    for m in tr.model.modules():
        if isinstance(m, DCNv3):
            m.register_forward_pre_hook(lambda *a: dcn.__setitem__(0, dcn[0] + 1))
    out = step_result(tr, state, job["batch"] if batch is None else batch)
    return out, calls, dcn[0], tr


def assert_steps_equal(got, want):
    assert np.array_equal(got["items"], want["items"])
    assert got["loss"] == want["loss"]
    for key in ("grads", "state", "ema"):
        assert got[key].keys() == want[key].keys()
        for k, w in want[key].items():
            g = got[key][k]
            assert (g is None and w is None) or torch.equal(g, w), (key, k)
    for k, w in want["state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(got["state"][k]) == 1, k  # the recompute leaves the count alone


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The multi-process cases, started before the module's first test so they
    run while this process computes the references: the nano DCNv3 model
    under DDP on 2 ranks and on a dp 1 x sp 2 mesh (float64), the semantic
    model on the mesh (float32), the narrow yolov5_seg under DDP (float64)."""
    job = job_of("nano_dcnv3", remat_layers=True, dtype=torch.float64)
    job = {**job, "batch": float64_batch(job["task"], job["batch"])}
    dead = dead_rows_job()
    jobs = [job, {**job, "mesh2d": (1, 2)}, job_of("resnet18", remat_layers=True, mesh2d=(1, 2)),
            {**dead, "batch": float64_batch("semantic", dead["batch"])}]
    handle = start_ranks({"kind": "bundle", "jobs": jobs}, tmp_path_factory.mktemp("remat"),
                         world=2, timeout=300)
    box = {}

    def results():
        if "r" not in box:
            box["r"] = join_ranks(handle)
        return jobs, box["r"]
    yield results
    results()


@pytest.mark.parametrize("key", sorted(SETTINGS))
@pytest.mark.parametrize("name", sorted(ONE_ROW))
def test_remat_step_equals_the_plain_step_bit_for_bit(name, key):
    task = CASES[name][0]
    job = job_of(name, dtype=torch.float64)
    batch = float64_batch(task, job["batch"])
    rl = setting(name, key)
    plain, plain_calls, plain_dcn, _ = counted_step(job, batch)
    got, calls, dcn, tr = counted_step({**job, "remat_layers": rl}, batch)
    assert_steps_equal(got, plain)
    rows = remat_rows(tr.model.spec, rl)
    assert rows and all(getattr(tr.model.model[i], "remat", False) == (i in rows)
                        for i in range(len(tr.model.model)))
    assert calls == {i: c * (2 if i in rows else 1) for i, c in plain_calls.items()}
    if name == "nano_dcnv3":  # DCNv3 in rows 4 (2 copies), 6 (3) and 8: K2's calls
        assert plain_dcn == 6
        assert dcn == 6 + sum(n for r, n in ((4, 2), (6, 3), (8, 1)) if r in rows)
    # the eval forward is the plain model's, once
    c0 = dict(calls)
    ref = build_trainer(job)[0].model
    ref.load_state_dict(plain["state"])
    x = torch.from_numpy(batch["image"])
    if task == "segment":
        x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        want, out = ref.eval()(x), tr.model.eval()(x)
    if task == "segment":
        want, out = want[0], out[0]
    assert torch.equal(out, want)
    assert calls == {i: c + plain_calls[i] for i, c in c0.items()}  # no recompute


def test_remat_rows_follow_jax():
    """True wraps every row but the heads and JAX's shape-only rows; a tuple
    its own rows of those; False none."""
    spec = build_trainer(job_of("yolov5n-seg"))[0].model.spec
    assert remat_rows(spec, False) == frozenset()
    assert remat_rows(spec, True) == frozenset(
        {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 13, 14, 17, 18, 20, 21, 23})
    assert remat_rows(spec, (0, 11, 12, 23, 24)) == frozenset({0, 23})


@pytest.mark.parametrize("name", ["nano_dcnv3", "resnet18"])
def test_nested_in_trainer_remat_and_under_autocast_equal_the_plain_step(name):
    """remat_layers=True inside Trainer(remat=True) (nested checkpoints: the
    outer recompute reruns the inner ones) equals the plain step bit for bit
    in float64; under torch.autocast bfloat16 (the segment model: the CPU
    has no bfloat16 resize for the semantic one) the float32 remat step
    equals the float32 plain bfloat16 step bit for bit."""
    task = CASES[name][0]
    job = job_of(name, dtype=torch.float64)
    batch = float64_batch(task, job["batch"])
    plain = counted_step(job, batch)[0]
    nested = counted_step({**job, "remat_layers": True, "remat": True}, batch)[0]
    assert_steps_equal(nested, plain)
    job32 = job_of(name)
    if task == "semantic":  # torch's CPU bilinear resize has no bfloat16 kernel
        return
    bf16 = counted_step(job32, amp_dtype=torch.bfloat16)[0]
    got = counted_step({**job32, "remat_layers": True}, amp_dtype=torch.bfloat16)[0]
    assert_steps_equal(got, bf16)


def jax_step(name, remat_layers):
    """JAX's float32 loss items, gradients and new batch statistics (as port
    state_dict keys) of `name` with `remat_layers`."""
    task, d, jcls, v, batch = CASES[name]
    jm = jcls(d, remat_layers=remat_layers)
    if task == "semantic":
        loss = JSemanticSegLoss(d["nc"])
    else:
        kw = jm.spec.layers[-1].kw()
        loss = JComputeSegmentLoss(kw["anchors"], kw["strides"], jm.nc, kw["nm"], HYP,
                                   overlap=True)
    tx = j_smart_optimizer(v["params"], "SGD", HYP, epochs=30, steps_per_epoch=5,
                           total_batch_size=BS)
    tr = JTrainer(jm, loss, tx, task=task)
    s = tr.init_state(v)
    with jax.default_matmul_precision("highest"):
        (_, (items, new_bs)), grads = jax.jit(jax.value_and_grad(tr._forward_loss, has_aux=True))(
            s.params, s.batch_stats, {k: jnp.asarray(a) for k, a in batch.items()})
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (np.asarray(items), state_dict_from_flax({"params": to_np(grads)}),
            state_dict_from_flax({"params": to_np(s.params), "batch_stats": to_np(new_bs)}))


@pytest.mark.parametrize("name,key", [("yolov5n-seg", "early"), ("nano_dcnv3", "true"),
                                      ("resnet18", "true")])
def test_remat_step_equals_jax_remat_step(name, key):
    rl = setting(name, key)
    items, grads, stats = jax_step(name, rl)
    got = counted_step(job_of(name, remat_layers=rl))[0]
    np.testing.assert_allclose(got["items"], items, rtol=ITEM_TOL, atol=1e-6)
    assert_each_close(got["grads"], grads, GRAD_TOL, GRAD_FLOOR)
    for k, w in stats.items():
        if "running" in k:
            np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=0, atol=STAT_TOL,
                                       err_msg=k)


def assert_each_close(got: dict, want: dict, tol: float, floor: float):
    """Each tensor of `want` (None: none in `got` either) within `tol` of its
    largest magnitude plus `floor` of the largest magnitude of all."""
    top = max(float(w.abs().max()) for w in want.values() if w is not None)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        gap = float((got[k].double() - w.double()).abs().max())
        assert gap <= tol * float(w.abs().max()) + floor * top, (k, gap)


@pytest.mark.parametrize("i,tol", [(0, 1e-9), (1, 1e-9), (2, 1e-4), (3, 1e-9)],
                         ids=["ddp_nano_dcnv3", "sp2_nano_dcnv3", "sp2_resnet18",
                              "ddp_yolov5_seg_dead_rows"])
def test_remat_on_ranks_matches_one_process(ranks, i, tol):
    """remat_layers=True on 2 ranks. Under DDP (find_unused_parameters) one
    DDP forward a step: the recompute reruns the rows, never DDP's forward,
    and yolov5_seg's dead rows (wrapped too) leave their gradients None.
    On dp 1 x sp 2 the recompute of a banded row exchanges its halo rows
    again, that of a gathered layer (the ResNet18's stages and head, the
    DCNv3 sampling's input) runs on the whole map. The ranks stay in step and
    hold the one-process plain step's items, gradients, parameters, EMA and
    statistics (updated once) within `tol`."""
    jobs, results = ranks()
    job = jobs[i]
    one = step_result(*build_trainer({k: v for k, v in job.items()
                                      if k not in ("remat_layers", "mesh2d")}), job["batch"])
    got = [r[i] for r in results]
    assert [r["ddp_forwards"] for r in got] == [1, 1]
    assert all((g is None) == (one["grads"][k] is None) for k, g in got[0]["grads"].items())
    if i == 3:
        assert any(g is None for g in one["grads"].values())  # the dead rows
    for key in ("state", "ema"):
        assert all(torch.equal(got[0][key][k], got[1][key][k]) for k in job["state_dict"]), key
    for r in got:
        np.testing.assert_allclose(r["items"], one["items"], rtol=tol, atol=1e-12)
        assert_each_close(r["grads"], one["grads"], tol, 1e-6 * tol)
        for key in ("state", "ema"):
            assert_each_close({k: t for k, t in r[key].items() if t.is_floating_point()},
                              {k: t for k, t in one[key].items() if t.is_floating_point()},
                              tol, 1e-6 * tol)
        assert all(int(t) == 1 for k, t in r["state"].items() if k.endswith("num_batches_tracked"))
