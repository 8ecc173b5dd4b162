"""Rank processes for tests/test_torch_port_dist.py: `run_ranks` spawns `world`
processes that join a gloo group through a FileStore under the test's tmp_path
(so pytest-xdist workers never share a rendezvous), runs one job on each rank
and returns each rank's result. Every join has a deadline: a rank that hangs
or dies fails the test instead of stalling it. The jobs import torch and the
port only, never JAX."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

EPOCHS, STEPS = 30, 5


def run_ranks(job: dict, tmp_path, world: int = 2, timeout: float = 240.0) -> list:
    """Run `job` (a dict, see `_rank`) on `world` gloo ranks; returns the ranks'
    results in rank order."""
    import torch.multiprocessing as mp
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{time.monotonic_ns()}"
    ctx = mp.start_processes(_rank, args=(world, f"file://{store}", str(tmp), job), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish {job['kind']} within {timeout} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, init: str, out_dir: str, job: dict):
    import torch.distributed as dist
    from yolo_dual_tpu_torch.parallel.mesh import init_distributed, make_mesh
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=init, world_size=world, rank=rank, timeout_s=120)
    try:
        result = JOBS[job["kind"]](make_mesh(device="cpu"), job)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the models and trainers, one process and per rank alike ---------------------------

def build_trainer(job: dict, mesh=None):
    """(Trainer, state) of `job`'s task from its config and state_dict: SGD on
    its `hyp` at inner step `count`, the EMA, the task's loss, and `remat`
    where the job sets it."""
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
    from yolo_dual_tpu_torch.parallel.mesh import shard_batch
    tr, state = build_trainer(job, mesh)
    calls = []  # DDP's forwards in the step: one, also where the backward recomputes
    tr.ddp.register_forward_pre_hook(lambda module, args: calls.append(1))
    out = step_result(tr, state, shard_batch(job["batch"], mesh))
    return {**out, "ddp_forwards": len(calls)}


def _eval_segment(mesh, job):
    from yolo_dual_tpu_torch.engine.validator import evaluate_segment
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.parallel.mesh import shard_batch
    model = SegmentationModel(job["cfg"], device="cpu")
    model.load_state_dict(job["state_dict"], strict=True)
    batches = [shard_batch(b, mesh) for b in job["batches"]]
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


JOBS = {"train": _train, "eval_segment": _eval_segment, "eval_semantic": _eval_semantic,
        "sync_bn": _sync_bn, "collectives": _collectives}
