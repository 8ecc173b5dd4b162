"""Data parallelism over torch.distributed (port of yolo_dual_tpu/parallel/mesh.py;
reference classify/train.py:313, utils/torch_utils.py:55-95).

JAX shards one global batch over a 1-D device mesh inside one jit: XLA inserts
the gradient all-reduce, and BatchNorm's statistics and the loss's normalisers
cover the global batch because the program sees it whole. The port runs one
process a rank (`python -m torch.distributed.run --nproc-per-node N -m ...`);
each rank holds its `batch_size / N` rows of the global batch, and the three
reductions are explicit:

- gradients: train/trainer.py wraps the model in DistributedDataParallel,
  which averages them over the ranks;
- BatchNorm: `convert_sync_batchnorm` makes every port BatchNorm
  (nn/common.py:BatchNorm2d and its subclasses) take its training statistics
  over the global batch, flax's E[x²] − E[x]²: the per-channel sum, sum of
  squares and count are all-reduced in the forward and their gradients in the
  backward;
- the losses: inside `across(mesh)`, `global_sum` and `mean_share` all-reduce
  each normaliser (positives, cells, pixels' weights, images), so the loss a
  rank computes is its share of the global-batch loss. The shares sum to JAX's
  loss, and N · share is what DDP's gradient average needs.

Backend rule (`pick_backend`): NCCL when every rank has a GPU of its own; gloo
on the CPU, or when ranks share a GPU (NCCL refuses two ranks on one device).
The rule picks once and logs its choice; nothing retries another backend.

`make_mesh_2d(dp, sp)` is JAX's data x space mesh: rank d·sp + s holds data
shard d's rows and band s of every image's rows (parallel/spatial.py runs the
model on the bands). Its `size` and `rank` are the data axis', so everything
above that shards or reduces over the data (the Loader's shards, the losses'
normalisers, `gather_batches`) reads them as on a 1-D mesh; BatchNorm and
DDP span the world.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from yolo_dual_tpu_torch.utils.general import LOGGER, select_device

TIMEOUT_S = 600  # a collective waits this long for a lost peer, then fails


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ranks of a run: `size` data shards, this process' data index `rank`
    and device; on a 2-D mesh also `sp` bands an image, this process' band
    `space_rank`, and the groups of the ranks that share its space index
    (`data_group`) and its data index (`space_group`). A 1-D mesh is the
    default group (sp 1, groups None)."""
    size: int
    rank: int
    device: torch.device
    backend: str = ""
    sp: int = 1
    space_rank: int = 0
    data_group: Any = None
    space_group: Any = None

    @property
    def world(self) -> int:
        return self.size * self.sp

    def __deepcopy__(self, memo):
        return self  # a deep copy of a module that holds the mesh (the EMA) shares it


def pick_backend(device: torch.device, local_world_size: int) -> str:
    """"nccl" when each of the `local_world_size` ranks on this host has a GPU of
    its own, else "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that torch.distributed.run describes in the
    environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`), or the one given by `init_method`,
    `world_size` and `rank`. Without either it does nothing and returns False,
    as JAX's does on one host. On CUDA the rank's device is
    cuda:(LOCAL_RANK mod the device count); a rank that finds no GPU raises
    (utils/general.py:select_device) instead of training on the CPU."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    world_size = int(os.environ.get("WORLD_SIZE", 1) if world_size is None else world_size)
    rank = int(os.environ.get("RANK", 0) if rank is None else rank)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = select_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = pick_backend(dev, local_world)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    LOGGER.info(f"torch.distributed: rank {rank} of {world_size}, backend {backend} "
                f"({local_world} ranks on this host, {torch.cuda.device_count()} GPUs)")
    if rank != 0:  # rank 0 alone logs, writes checkpoints and results
        LOGGER.setLevel("WARNING")
    return True


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The default process group as a Mesh (one rank and size 1 without one).
    `device`: the rank's device, by default its CUDA device when CUDA is up,
    else the CPU. `n_devices`, when given, must be the world size."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has {size} ranks")
    if device is None:
        device = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    backend = dist.get_backend() if dist.is_initialized() else ""
    return Mesh(size, rank, torch.device(device), backend)


def make_mesh_2d(dp: int, sp: int, device=None) -> Mesh:
    """JAX's data x space mesh (JAX parallel/mesh.py:46): the process group's
    dp·sp ranks as dp data shards of sp bands each, space innermost, so rank
    r = d·sp + s. Every rank builds every group (torch.distributed.new_group
    is collective) and keeps its own two. Raises ValueError when the world
    is not dp·sp. `device` as make_mesh's."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"make_mesh_2d({dp}, {sp}): the process group has {world} ranks, "
                         f"not dp·sp = {dp * sp}")
    mesh = make_mesh(device=device)
    rank = mesh.rank  # the world rank
    data_group = space_group = None
    if world > 1:
        for s in range(sp):
            g = dist.new_group([d * sp + s for d in range(dp)])
            if rank % sp == s:
                data_group = g
        for d in range(dp):
            g = dist.new_group([d * sp + s for s in range(sp)])
            if rank // sp == d:
                space_group = g
    return dataclasses.replace(mesh, size=dp, rank=rank // sp, sp=sp, space_rank=rank % sp,
                               data_group=data_group, space_group=space_group)


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world > 1


def batch_spec(mesh: Mesh, leaf_ndim: int) -> tuple:
    """The axis each dimension of a batch leaf is split over (JAX
    parallel/mesh.py:65, a PartitionSpec there): the leading (batch) dim over
    "data" and, on a 2-D mesh, dim 1 (H of NHWC images) of a leaf with at
    least 3 dims over "space"; None for the rest."""
    spec = [None] * leaf_ndim
    if leaf_ndim >= 1:
        spec[0] = "data"
    if mesh.sp > 1 and leaf_ndim >= 3:
        spec[1] = "space"
    return tuple(spec)


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank, in place: a module's parameters and
    buffers, or a tensor or a list of tensors. Returns `tree`."""
    if _active(mesh):
        if isinstance(tree, torch.nn.Module):
            tensors = [*tree.parameters(), *tree.buffers()]
        else:
            tensors = [tree] if isinstance(tree, torch.Tensor) else list(tree)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, 0)
    return tree


def rows_of(n: int, mesh: Mesh) -> int:
    """How many of the first `n` rows of a global batch are this rank's under
    the strided split (rows rank, rank + size, ...)."""
    return max(0, -(-(n - mesh.rank) // mesh.size))


# leaves whose dim 1 is H: JAX's _SPATIAL_KEYS also holds "mask" and "masks", which the
# port keeps whole on every space rank because only the loss reads them
_SPATIAL_KEYS = ("image", "images")


def band_rows(n: int, mesh: Mesh) -> slice:
    """The rows of a map of `n` rows that are this rank's band."""
    if n % mesh.sp:
        raise ValueError(f"a map of {n} rows does not split into {mesh.sp} bands")
    h = n // mesh.sp
    return slice(mesh.space_rank * h, (mesh.space_rank + 1) * h)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch: rows rank, rank + size, ... of each
    leaf with a leading dimension (the Loader's split, data/loader.py), and
    `n_valid` counted over them; on a 2-D mesh also, of the `_SPATIAL_KEYS`
    leaves with at least 3 dims, the band of dim 1 that `batch_spec` puts on
    "space" (`band_rows`): what Trainer.train_step takes (engine/validator.py
    takes whole frames, shard_loader's shards, and bands them itself).
    Scalars pass through."""
    def take(k, x):
        if k == "n_valid":
            return np.int32(rows_of(int(x), mesh))
        if np.ndim(x) < 1:
            return x
        x = x[mesh.rank::mesh.size] if mesh.size > 1 else x
        if k in _SPATIAL_KEYS and "space" in batch_spec(mesh, np.ndim(x)):
            x = x[:, band_rows(x.shape[1], mesh)]
        return x
    if not _active(mesh):
        return batch
    if isinstance(batch, dict):
        return {k: take(k, v) for k, v in batch.items()}
    return [take("", v) for v in batch]


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks, differentiable: the gradient of every
    rank's input is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the ranks of `group` (default: the world), with its
    gradient (SyncBN's statistics)."""
    return _AllReduceSum.apply(x, group)


def cross_replica_mean(tree, mesh: Mesh):
    """The mean over the data axis' ranks of a tensor, or of each tensor of a
    dict or list (JAX's pmean over "data"); differentiable, the gradient
    flows back to every rank."""
    def mean(x):
        return all_reduce_sum(x, mesh.data_group) / mesh.size
    if not _active(mesh):
        return tree
    if isinstance(tree, dict):
        return {k: mean(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mean(v) for v in tree)
    return mean(tree)


def sync_hosts(name: str = "barrier"):
    """Barrier over the ranks (reference torch_distributed_zero_first); `name`
    is JAX's tag and unused."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# --- the global batch's normalisers -------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def across(mesh: Optional[Mesh]):
    """Inside, `global_sum` and `mean_share` reduce over `mesh`'s ranks (the
    losses' normalisers; train/trainer.py, engine/validator.py)."""
    token = _MESH.set(mesh if _active(mesh) else None)
    try:
        yield
    finally:
        _MESH.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `across` with more than one rank, or None."""
    return _MESH.get()


def global_sum(x):
    """`x` summed over the data axis' ranks of the active mesh (the space
    ranks of a data shard hold the same value), outside autograd (a
    normaliser: gradients flow through the local terms only); `x` itself
    without one. Takes a tensor or a number."""
    mesh = _MESH.get()
    if mesh is None:
        return x
    t = torch.as_tensor(x).detach().clone()
    if mesh.size == 1:
        return t
    if t.device.type == "cpu" and mesh.device.type == "cuda" and mesh.backend == "nccl":
        t = t.to(mesh.device)
    dist.all_reduce(t, group=mesh.data_group)
    return t.to(x.device) if isinstance(x, torch.Tensor) else t


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """`x.mean()` without an active mesh; with one, this rank's share of the
    mean over every rank's elements: x.sum() / their count. The shares sum
    to the global mean."""
    if _MESH.get() is None:
        return x.mean()
    n = global_sum(torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device))
    return x.sum() / n.to(x.dtype)


def convert_sync_batchnorm(model: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Make every port BatchNorm in `model` synchronise its training statistics
    over `mesh` (nn/common.py:BatchNorm2d.forward), in place; `mesh` None
    turns it off. Its eps, momentum, biased running variance, parameters and
    state_dict keys stay as they are (torch.nn.SyncBatchNorm would replace
    the module and feed the unbiased variance to running_var). Returns
    `model`."""
    from yolo_dual_tpu_torch.nn.common import BatchNorm2d
    others = [n for n, m in model.named_modules()
              if isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and not isinstance(m, BatchNorm2d)]
    if others:
        raise TypeError(f"BatchNorms outside the port's BatchNorm2d cannot synchronise: {others}")
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh if _active(mesh) else None
    return model


def gather_batches(per_batch: list, mesh: Optional[Mesh]) -> list:
    """Every rank's per-image records in global-batch order. `per_batch` is this
    rank's list of batches, each a list of its images' records: rows rank,
    rank + size, ... of each global batch (data/loader.py:Loader's shards),
    so global row p of batch k is row p // size of rank p % size. Every rank
    gets the whole list (torch.distributed.all_gather_object); on a 2-D mesh
    the lists of the ranks with space index 0 alone, one a data shard."""
    if not _active(mesh):
        return [r for b in per_batch for r in b]
    world = [None] * mesh.world
    dist.all_gather_object(world, per_batch)
    ranks = world[::mesh.sp]  # rank d·sp: data shard d's space index 0
    out = []
    for k in range(len(per_batch)):  # the same number of batches on every rank
        rows = [ranks[r][k] for r in range(mesh.size)]
        for j in range(max(map(len, rows))):
            out += [rows[r][j] for r in range(mesh.size) if j < len(rows[r])]
    return out


def shard_loader(loader, mesh: Optional[Mesh]):
    """Make a data/loader.py:Loader built for the global batch yield this
    rank's rows of each global batch (its `batch_size / size` of them), in
    place, and reseed its dataset's augmentation generators (`rng`, `np_rng`)
    with the loader's seed + rank, so the ranks draw different augmentations.
    The batch size must divide by the world size. On a 2-D mesh the shards
    are the data axis' (`size`, `rank`): the space ranks of a data shard load
    and augment the same rows, and `shard_batch` cuts their bands. Returns
    `loader`."""
    if mesh is None or mesh.size == 1:
        return loader
    if loader.batch_size % mesh.size:
        raise ValueError(f"batch size {loader.batch_size} does not split over {mesh.size} ranks")
    loader.batch_size //= mesh.size
    loader.num_shards, loader.shard_index = mesh.size, mesh.rank
    for name in ("rng", "np_rng"):
        gen = getattr(loader.dataset, name, None)
        if gen is not None:
            gen.seed(loader.seed + mesh.rank)
    return loader


def data_parallel(device="cuda") -> Optional[Mesh]:
    """The CLIs' --data-parallel: join the process group that
    torch.distributed.run describes and return its Mesh on the rank's device;
    None when the run is one process (no such environment, or a world of 1),
    which then runs as without the flag, as JAX's CLIs do on one device."""
    init_distributed(device)
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    dev = torch.device(device)
    return make_mesh(device=f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu")


def is_main(mesh: Optional[Mesh]) -> bool:
    """True on rank 0, or without a mesh: the rank that writes files."""
    return mesh is None or (mesh.rank == 0 and mesh.space_rank == 0)


def from_rank0(fn, mesh: Optional[Mesh]):
    """fn() run on rank 0 alone (a run directory made there) and its result
    sent to every rank; fn() itself without a mesh."""
    if not _active(mesh):
        return fn()
    box = [fn() if is_main(mesh) else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@contextlib.contextmanager
def rank0_first(mesh: Optional[Mesh]):
    """Rank 0 runs the block before the other ranks do (reference
    torch_distributed_zero_first): a dataset's label or mask cache is written
    once, then read by the rest."""
    if _active(mesh) and not is_main(mesh):
        sync_hosts("rank0_first")
    yield
    if _active(mesh) and is_main(mesh):
        sync_hosts("rank0_first")
