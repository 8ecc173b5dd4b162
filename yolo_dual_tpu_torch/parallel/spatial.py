"""Spatial partitioning over the space axis of a 2-D mesh (port of what XLA's
SPMD partitioner does for JAX's `make_mesh_2d`, yolo_dual_tpu/parallel/mesh.py:46;
JAX train/trainer.py:170-187).

On a mesh of dp x sp ranks (parallel/mesh.py:make_mesh_2d) rank d·sp + s
holds band s of every activation of data shard d: rows [s·h, (s + 1)·h) of a
map of sp·h rows. Inside `spatial(mesh)` the model runs on its bands:

- a layer that mixes rows exchanges halo rows with its neighbours first
  (`halo_rows`): a convolution of kernel k, stride s, padding p and dilation
  d needs (p, d·(k−1)+1 − s − p) rows above and below its band (`halo`), a
  k x k stride-1 max-pool (k // 2, k // 2); beyond the image's edges the halo
  is the layer's own padding, 0 for convolutions and −inf for max-pools, so
  the layer then runs with no padding along H. A band's height must be a
  multiple of the stride (models/model.py checks the input's height once);
- a layer that cannot run on a band runs on the whole map: its input's rows
  are gathered over the space group (`gather_rows`), it runs there, and the
  rank keeps its own rows of the output (`keep_rows`). models/model.py:_walk
  picks per layer; DCNv3's sampling gathers its input the same way (nn/dcn.py).

Every exchange is one all_reduce over the space group of a zero-filled buffer
with a slot a rank, each rank filling its own: an all-gather that every
backend takes on every device (gloo's all_reduce of CUDA tensors included).

Gradients. `halo_rows`' backward sends each halo row's gradient to the rank
that owns the row, which adds it to its own. `gather_rows` has two backwards:
where every space rank goes on with the same whole map (the head's outputs
before a loss that every space rank computes whole), each keeps its own rows
of the gradient; where every space rank computes a different part of the
result from the whole map (a gathered layer whose output each rank cuts to
its band, DCNv3's sampling of its band's rows), the gradients are summed
over the space group first (`sum_grads=True`). A rank's parameter gradients
are then its band's share, and the trainer's DDP adds the shares
(train/trainer.py).

`counts` tallies the exchanges by site ("halo Conv", "halo max_pool",
"gather dcnv3", "gather head", "gather layer <name>", "gather output"):
tests and chip_smoke.py read which layers ran on bands and which gathered.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

counts: collections.Counter = collections.Counter()

_SPACE: contextvars.ContextVar = contextvars.ContextVar("space", default=None)


@contextlib.contextmanager
def spatial(mesh):
    """Inside, the model runs on this rank's bands of `mesh`'s space axis
    (nothing changes for a mesh with one band, or None)."""
    token = _SPACE.set(mesh if mesh is not None and mesh.sp > 1 else None)
    try:
        yield
    finally:
        _SPACE.reset(token)


@contextlib.contextmanager
def whole_maps():
    """Inside, layers run on whole maps (a gathered layer's body)."""
    token = _SPACE.set(None)
    try:
        yield
    finally:
        _SPACE.reset(token)


def space_mesh():
    """The mesh of the enclosing `spatial` with more than one band, or None."""
    return _SPACE.get()


def halo(kernel: int, stride: int, pad: int, dilation: int = 1):
    """(rows above, rows below) a band needs for a layer along H: stem k6 s2
    p2 (2, 2), k3 s2 p1 (1, 0), k3 s1 p1 (1, 1), SPPF's k5 s1 p2 (2, 2). The
    count below is negative where the layer never reads the band's last rows."""
    return pad, dilation * (kernel - 1) + 1 - stride - pad


def check_height(h: int, mesh, stride: int):
    """A map of `h` rows must split into mesh.sp bands whose heights the
    model's largest `stride` divides: h a multiple of sp x stride."""
    if h % (mesh.sp * stride):
        raise ValueError(f"spatial partitioning: an input of H = {h} rows is not a multiple "
                         f"of sp x the model's largest stride = {mesh.sp} x {stride} = "
                         f"{mesh.sp * stride}")


def _slot_exchange(local: torch.Tensor, mesh) -> torch.Tensor:
    """(sp, *local.shape): every space rank's `local`, by an all_reduce of a
    zero buffer in which this rank fills slot space_rank."""
    buf = local.new_zeros((mesh.sp, *local.shape))
    buf[mesh.space_rank] = local
    dist.all_reduce(buf, group=mesh.space_group)
    return buf


class _HaloRows(torch.autograd.Function):
    """Forward: the band with `top` rows above it and `bottom` below, taken
    from the ranks that own them, `fill` beyond the map's edges. Each rank
    sends its last min(top, h) rows (its tail) and first min(bottom, h) rows
    (its head); where a halo is taller than a band, the tails and heads are
    whole bands and the halo spans several ranks. Backward: the halo rows'
    gradients go back through the same buffer, summed over the group, and
    each rank adds its slot to its tail's and head's gradients."""

    @staticmethod
    def forward(ctx, x, top: int, bottom: int, fill: float, mesh, dim: int):
        h = x.shape[dim]
        nt, nb = min(top, h), min(bottom, h)
        ctx.geometry = (top, bottom, nt, nb, h, mesh, dim)
        buf = _slot_exchange(torch.cat([x.narrow(dim, h - nt, nt), x.narrow(dim, 0, nb)], dim),
                             mesh)
        s = mesh.space_rank

        def edge(n):
            shape = list(x.shape)
            shape[dim] = n
            return x.new_full(shape, fill)
        above = torch.cat([edge(top)] + [buf[j].narrow(dim, 0, nt) for j in range(s)], dim)
        below = torch.cat([buf[j].narrow(dim, nt, nb) for j in range(s + 1, mesh.sp)]
                          + [edge(bottom)], dim)
        return torch.cat([above.narrow(dim, above.shape[dim] - top, top), x,
                          below.narrow(dim, 0, bottom)], dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, nt, nb, h, mesh, dim = ctx.geometry
        s, sp = mesh.space_rank, mesh.sp
        g_top, g_mid, g_bot = g.narrow(dim, 0, top), g.narrow(dim, top, h), \
            g.narrow(dim, top + h, bottom)
        shape = list(g.shape)
        shape[dim] = nt + nb
        gbuf = g.new_zeros((sp, *shape))
        # the transpose of the forward's `above`: g_top is its last `top` rows, of which
        # those past the fill belong to the tails of ranks 0 .. s-1
        k = top
        for j in range(s - 1, -1, -1):
            if k <= 0:
                break
            n = min(nt, k)
            gbuf[j].narrow(dim, nt - n, n).copy_(g_top.narrow(dim, k - n, n))
            k -= n
        k = 0
        for j in range(s + 1, sp):
            if k >= bottom:
                break
            n = min(nb, bottom - k)
            gbuf[j].narrow(dim, nt, n).copy_(g_bot.narrow(dim, k, n))
            k += n
        dist.all_reduce(gbuf, group=mesh.space_group)
        gx = g_mid.clone()
        gx.narrow(dim, h - nt, nt).add_(gbuf[s].narrow(dim, 0, nt))
        gx.narrow(dim, 0, nb).add_(gbuf[s].narrow(dim, nt, nb))
        return gx, None, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, fill: float = 0.0, dim: int = 2,
              mesh=None) -> torch.Tensor:
    """This rank's band of `x` along `dim` (H of NCHW) with `top` rows of halo
    above and `bottom` below (`halo`), `fill` beyond the map's edges; a
    negative `bottom` drops that many of the band's last rows after the
    exchange. Differentiable: the halo's gradient is added to the rows'
    owners. `mesh`: default the active `spatial` one."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None or (top <= 0 and bottom <= 0):
        return x if bottom >= 0 else x.narrow(dim, 0, x.shape[dim] + bottom)
    y = _HaloRows.apply(x, max(top, 0), max(bottom, 0), float(fill), mesh, dim)
    return y if bottom >= 0 else y.narrow(dim, 0, y.shape[dim] + bottom)


class _GatherRows(torch.autograd.Function):
    """The whole map from the space ranks' bands along `dim`. Backward: with
    `sum_grads`, the gradient summed over the space group, then this rank's
    rows; without, this rank's rows of its own gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim: int, sum_grads: bool):
        ctx.geometry = (mesh, dim, sum_grads, x.shape[dim])
        return torch.cat(_slot_exchange(x.contiguous(), mesh).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, sum_grads, h = ctx.geometry
        if sum_grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.space_group)
        return g.narrow(dim, mesh.space_rank * h, h).contiguous(), None, None, None


def gather_rows(x: torch.Tensor, dim: int = 2, sum_grads: bool = False, mesh=None,
                site: Optional[str] = None) -> torch.Tensor:
    """The whole map of the space ranks' bands `x` along `dim`. `sum_grads`:
    each space rank computes a different part of what follows (see the
    module's docstring). `site` is counted in `counts`."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None:
        return x
    if site:
        counts[f"gather {site}"] += 1
    return _GatherRows.apply(x, mesh, dim, sum_grads)


def keep_rows(x: torch.Tensor, dim: int = 2, mesh=None) -> torch.Tensor:
    """This rank's band of a whole map along `dim`; the gradient of the other
    rows is zero. The map's rows must split into sp bands."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None:
        return x
    n = x.shape[dim]
    if n % mesh.sp:
        raise ValueError(f"spatial partitioning: a map of {n} rows does not split into "
                         f"{mesh.sp} bands")
    h = n // mesh.sp
    return x.narrow(dim, mesh.space_rank * h, h)


class _ShareGrad(torch.autograd.Function):
    """Identity forward; backward divides the gradient by sp: the space ranks
    hold the same output and each counts a share of its gradient."""

    @staticmethod
    def forward(ctx, x, sp: int):
        ctx.sp = sp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.sp, None


def share_grad(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """`x`, which every space rank holds whole, with each rank's gradient its
    1/sp share (models/model.py: a model output without rows, Classify's)."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None or not x.is_floating_point():
        return x
    return _ShareGrad.apply(x, mesh.sp)


def conv2d(x: torch.Tensor, conv: torch.nn.Conv2d) -> torch.Tensor:
    """`conv` on this rank's band: its halo rows exchanged, no padding along H."""
    (kh, _), (sh, _), (ph, pw), (dh, _) = (conv.kernel_size, conv.stride, conv.padding,
                                           conv.dilation)
    if x.shape[2] % sh:
        raise ValueError(f"spatial partitioning: a band of {x.shape[2]} rows does not divide "
                         f"by the stride {sh}")
    top, bottom = halo(kh, sh, ph, dh)
    if top > 0 or bottom > 0:
        counts["halo Conv"] += 1
    x = halo_rows(x, top, bottom, 0.0)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, pw), conv.dilation, conv.groups)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """A k x k stride-1 max pool on this rank's band: k // 2 halo rows of −inf
    beyond the map's edges, as the padding is."""
    counts["halo max_pool"] += 1
    x = halo_rows(x, k // 2, k // 2, float("-inf"))
    return F.max_pool2d(x, k, 1, (0, k // 2))
