"""Rank processes for tests/test_torch_port_dist.py: `run_ranks` spawns `world`
processes that join a gloo group through a FileStore under the test's tmp_path
(so pytest-xdist workers never share a rendezvous), runs one job on each rank
and returns each rank's result. Every join has a deadline: a rank that hangs
or dies fails the test instead of stalling it. The jobs import torch and the
port only, never JAX."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

EPOCHS, STEPS = 30, 5


def run_ranks(job: dict, tmp_path, world: int = 2, timeout: float = 240.0) -> list:
    """Run `job` (a dict, see `_rank`) on `world` gloo ranks; returns the ranks'
    results in rank order. `job["mesh2d"] = (dp, sp)` gives the job a 2-D
    mesh (parallel/mesh.py:make_mesh_2d) of the `world` = dp·sp ranks."""
    return join_ranks(start_ranks(job, tmp_path, world, timeout))


def start_ranks(job: dict, tmp_path, world: int = 2, timeout: float = 240.0):
    """`run_ranks` started: the caller may work while the ranks run, then
    `join_ranks` the handle."""
    import torch.multiprocessing as mp
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    stamp = time.monotonic_ns()
    # the job goes by file: pickled into each child's start pipe it would block every start
    # until that child had imported torch, one child after another
    torch.save(job, tmp / f"job_{stamp}.pt")
    ctx = mp.start_processes(_rank, args=(world, f"file://{tmp / f'store_{stamp}'}", str(tmp),
                                          str(tmp / f"job_{stamp}.pt")), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, time.monotonic() + timeout, tmp, world, job["kind"]


def join_ranks(handle) -> list:
    ctx, deadline, tmp, world, kind = handle
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish {kind} in time")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, init: str, out_dir: str, job_file: str):
    import torch.distributed as dist
    job = torch.load(job_file, weights_only=False)
    from yolo_dual_tpu_torch.parallel.mesh import init_distributed, make_mesh, make_mesh_2d
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init, world_size=world, rank=rank, timeout_s=120)
    try:
        mesh = make_mesh_2d(*job["mesh2d"], device="cpu") if "mesh2d" in job \
            else make_mesh(device="cpu")
        result = JOBS[job["kind"]](mesh, job)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the models and trainers, one process and per rank alike ---------------------------

def build_trainer(job: dict, mesh=None):
    """(Trainer, state) of `job`'s task from its config and state_dict: SGD on
    its `hyp` at inner step `count`, the EMA, the task's loss, and `remat`
    and the model's `dtype` (float32) where the job sets them."""
    from yolo_dual_tpu_torch.classify.train import build_classifier
    from yolo_dual_tpu_torch.losses.segment import ComputeSegmentLoss
    from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
    from yolo_dual_tpu_torch.models.model import SegmentationModel, SemanticSegModel
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer, classify_loss
    task = job["task"]
    if task == "segment":
        model = SegmentationModel(job["cfg"], device="cpu")
        head = model.model[-1]
        loss = ComputeSegmentLoss(head.anchors, head.strides, model.nc, head.nm, job["hyp"],
                                  overlap=True)
    elif task == "semantic":
        model = SemanticSegModel(job["cfg"], device="cpu")
        loss = SemanticSegLoss(model.nc, flavor="dice")
    else:
        model = build_classifier(job["cfg"], job["nc"], device="cpu")
        loss = lambda logits, labels: classify_loss(logits, labels, 0.1)  # noqa: E731
    model.load_state_dict(job["state_dict"], strict=True)
    model = model.to(job.get("dtype", torch.float32))
    opt = smart_optimizer(model, "SGD", job["hyp"], epochs=EPOCHS, steps_per_epoch=STEPS,
                          total_batch_size=job["batch_size"])
    opt.count = job.get("count", 0)
    tr = Trainer(model, loss, opt, ModelEMA(model), task=task, mesh=mesh,
                 remat=job.get("remat", False))
    return tr, tr.init_state()


def step_result(tr, state, batch) -> dict:
    """One train_step of `batch`: the new state_dict, the EMA's, the loss and
    its items, and every parameter's gradient."""
    state, metrics = tr.train_step(state, batch)
    return {"state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.ema.state_dict().items()},
            "loss": float(metrics["loss"]), "items": metrics["items"].numpy().copy(),
            "grads": {k: p.grad.clone() if p.grad is not None else None
                      for k, p in state.model.named_parameters()}}


def _train(mesh, job):
    """`job["steps"]` (default 1) train steps of `job["batch"]`: the last
    step's step_result, every step's loss, and DDP's forwards in all."""
    from yolo_dual_tpu_torch.parallel.mesh import shard_batch
    tr, state = build_trainer(job, mesh)
    calls = []  # DDP's forwards in the step: one, also where the backward recomputes
    tr.ddp.register_forward_pre_hook(lambda module, args: calls.append(1))
    losses = []
    for _ in range(job.get("steps", 1)):
        out = step_result(tr, state, shard_batch(job["batch"], mesh))
        losses.append(out["loss"])
    return {**out, "losses": losses, "ddp_forwards": len(calls)}


def _eval_segment(mesh, job):
    from yolo_dual_tpu_torch.engine.validator import evaluate_segment
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.parallel.mesh import shard_batch
    model = SegmentationModel(job["cfg"], device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    rows = dataclasses.replace(mesh, sp=1, space_rank=0)  # a data shard's whole frames
    batches = [shard_batch(b, rows) for b in job["batches"]]
    mean, maps, _ = evaluate_segment(model, batches, job["nc"], device="cpu", mesh=mesh,
                                     **job["kw"])
    return {"mean": np.asarray(mean, np.float64), "maps": np.asarray(maps)}


def _eval_semantic(mesh, job):
    from yolo_dual_tpu_torch.engine.validator import evaluate_semantic
    from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    from yolo_dual_tpu_torch.parallel.mesh import shard_batch
    model = SemanticSegModel(job["cfg"], device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    batches = [shard_batch(b, mesh) for b in job["batches"]]
    (miou, vloss, _, _), iou, _ = evaluate_semantic(
        model, batches, job["nc"], ignore_index=None, loss_fn=SemanticSegLoss(job["nc"]),
        device="cpu", mesh=mesh)
    return {"miou": miou, "loss": vloss, "iou": iou}


def _sync_bn(mesh, job):
    """The port's BatchNorm2d, synchronised, on this rank's rows of `x`: its
    output rows, the input's and parameters' gradients of sum(output · w), and
    the running statistics."""
    from yolo_dual_tpu_torch.nn.common import BatchNorm2d
    from yolo_dual_tpu_torch.parallel.mesh import convert_sync_batchnorm
    x = torch.from_numpy(job["x"][mesh.rank::mesh.size]).requires_grad_(True)
    w = torch.from_numpy(job["w"][mesh.rank::mesh.size])
    bn = BatchNorm2d(x.shape[1], eps=job["eps"], momentum=job["momentum"])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["scale"]))
        bn.bias.copy_(torch.from_numpy(job["bias"]))
    convert_sync_batchnorm(bn, mesh)
    y = bn.train()(x)
    (y * w).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def _collectives(mesh, job):
    """replicate, cross_replica_mean and its gradient, and global_sum and
    mean_share inside `across`, on small tensors that differ by rank."""
    from yolo_dual_tpu_torch.parallel.mesh import (across, cross_replica_mean, global_sum,
                                                   mean_share, replicate)
    t = replicate(torch.tensor([float(mesh.rank + 1)]), mesh)
    x = torch.tensor(float(mesh.rank), requires_grad=True)
    m = cross_replica_mean(x, mesh)
    m.backward()
    with across(mesh):
        total = global_sum(torch.tensor(mesh.rank + 1))
        share = mean_share(torch.arange(mesh.rank + 2, dtype=torch.float32))
    return {"replicated": float(t), "mean": float(m), "grad": float(x.grad), "sum": int(total),
            "share": float(share)}


def _spatial_ops(mesh, job):
    """The row-mixing ops of parallel/spatial.py on this rank's band of its
    data shard's rows of `job["x"]` (float64 NCHW): each conv of `job["convs"]`
    (k, s, p, d: spatial.conv2d), each max_pool_same of `job["pools"]`, and a
    gathered BatchNorm (gather_rows with summed gradients, the port's
    BatchNorm2d synchronised over the world, keep_rows). For each: the output
    band, the gradient of sum(output · w) (w: `job["w"][name]`, the whole
    output's weights) at the band, and the parameters' gradients."""
    from yolo_dual_tpu_torch.nn.common import BatchNorm2d, max_pool_same
    from yolo_dual_tpu_torch.parallel import spatial
    from yolo_dual_tpu_torch.parallel.mesh import band_rows, convert_sync_batchnorm
    torch.manual_seed(0)
    rows = slice(mesh.rank, None, mesh.size)
    out = {}

    def run(name, op, params=()):
        x = job["x"][rows]
        xb = torch.from_numpy(np.ascontiguousarray(x[:, :, band_rows(x.shape[2], mesh)]))
        xb.requires_grad_(True)
        with spatial.spatial(mesh):
            y = op(xb)
        w = torch.from_numpy(job["w"][name][rows])
        (y * w[:, :, band_rows(w.shape[2], mesh)]).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dx": xb.grad.numpy(),
                     "dparams": [p.grad.numpy().copy() for p in params]}

    for k, s, p, d in job["convs"]:
        conv = torch.nn.Conv2d(job["x"].shape[1], 3, k, s, p, d, dtype=torch.float64)
        conv.load_state_dict({n: torch.from_numpy(v) for n, v in job["conv_weights"][
            f"conv k{k} s{s} p{p} d{d}"].items()})
        run(f"conv k{k} s{s} p{p} d{d}", lambda t, conv=conv: spatial.conv2d(t, conv),
            (conv.weight, conv.bias))
    for k in job["pools"]:
        run(f"pool k{k}", lambda t, k=k: max_pool_same(t, k))
    bn = convert_sync_batchnorm(BatchNorm2d(job["x"].shape[1], dtype=torch.float64), mesh).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn_scale"]))
    run("gathered bn", lambda t: spatial.keep_rows(bn(spatial.gather_rows(t, sum_grads=True))),
        (bn.weight, bn.bias))
    out["gathered bn"]["stats"] = [bn.running_mean.numpy(), bn.running_var.numpy()]
    return out


def _band_forward(mesh, job):
    """`job["cfg"]`'s model (seeded), one train-mode forward of this rank's
    rows and band of `job["x"]` under `spatial`, with `spatial.counts` set to
    0 just before: the raw outputs (whole on every space rank) and the counts."""
    from yolo_dual_tpu_torch.models.model import build_model
    from yolo_dual_tpu_torch.nn.common import Conv
    from yolo_dual_tpu_torch.parallel import spatial
    from yolo_dual_tpu_torch.parallel.mesh import convert_sync_batchnorm, shard_batch
    model = build_model(job["cfg"], device="cpu", generator=torch.Generator().manual_seed(0))
    convert_sync_batchnorm(model, mesh)
    x = torch.from_numpy(shard_batch({"image": job["x"]}, mesh)["image"]).permute(0, 3, 1, 2)
    spatial.counts.clear()
    with spatial.spatial(mesh), torch.no_grad():
        levels, protos = model.train()(x.contiguous(), decode=False)
    return {"levels": [t.numpy() for t in levels], "protos": protos.numpy(),
            "counts": dict(spatial.counts),
            "halo_convs": sum(isinstance(m, Conv) and m.conv.kernel_size[0] > 1
                              for m in model.modules())}


def _refusals(mesh, job):
    """make_mesh_2d on a world that is not dp·sp: the ValueError's text."""
    from yolo_dual_tpu_torch.parallel.mesh import make_mesh_2d
    try:
        make_mesh_2d(3, 1, device="cpu")
    except ValueError as e:
        return {"world": str(e)}
    return {"world": None}


def _bundle(mesh, job):
    """Each of `job["jobs"]` on the ranks in turn, each on its own 2-D mesh
    `mesh2d` (one a shape, built once) or the default group's: their results."""
    from yolo_dual_tpu_torch.parallel.mesh import make_mesh_2d
    meshes, out = {}, []
    for sub in job["jobs"]:
        m = mesh
        if "mesh2d" in sub:
            key = tuple(sub["mesh2d"])
            m = meshes.setdefault(key, make_mesh_2d(*key, device="cpu"))
        out.append(JOBS[sub["kind"]](m, sub))
    return out


JOBS = {"train": _train, "eval_segment": _eval_segment, "eval_semantic": _eval_semantic,
        "sync_bn": _sync_bn, "collectives": _collectives, "spatial_ops": _spatial_ops,
        "band_forward": _band_forward, "refusals": _refusals, "bundle": _bundle}
