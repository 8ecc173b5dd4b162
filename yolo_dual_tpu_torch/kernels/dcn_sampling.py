"""DCNv3 deformable sampling and its gradient (port of
yolo_dual_tpu/kernels/dcn_sampling.py and of the sampling core in
yolo_dual_tpu/nn/dcn.py).

`dcnv3_sampling` is a `torch.autograd.Function`, as the JAX `custom_vjp` is. On
CUDA tensors its forward launches the hand-written kernel csrc/dcnv3.cu and its
backward csrc/dcnv3_bwd.cu (`dcnv3_sampling_backward`); on CPU tensors the
forward is the plain `dcnv3_core` and the backward the plain `dcnv3_core_bwd`
(on meta tensors, which carry shapes only, the forward is `dcnv3_core`: the
model's stride probe runs on them). All tensors are channels-last, as in the
JAX package: x (B, H, W, C = g·gc), offset (B, Ho, Wo, g·kk·2) as (Δx, Δy)
pairs, mask (B, Ho, Wo, g·kk) softmaxed over kk; the output is (B, Ho, Wo, C).
The kernels take float32 or bfloat16, every tensor of a call of one type, as
JAX's kernels take them: they compute in float32 and store each output in its
input's type, so a bfloat16 call gives the float32 call's outputs on float32
copies, rounded. The plain versions take any one floating type; below float32
they compute in float32 and return the inputs' types, as JAX's kernels do
(float64 for a CPU reference or gradcheck stays float64).

K3 gives the same bits on every run, as JAX's kernel does: dx is summed in
fixed point (csrc/dcnv3_bwd.cu), doffset and dmask in a fixed order.

`row0` is the global row of the first output row: a space rank of a 2-D mesh
(parallel/spatial.py) samples its band's Ho output rows, from its band's
offsets and mask, at their global positions in the whole gathered x, and K3's
dx covers that whole map. With row0 = 0 and the whole map every function is
what it was without it.

`dcnv3_core_grid_sample` is the reference's grid_sample formulation of the same
function; chip_smoke.py times it, and its autograd backward, as a yardstick and
nothing in the package calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


def bilinear_sample_nhwc(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling. img (B, H, W, C); sx/sy (B, P) pixel
    coordinates (integer coordinates hit pixel centers). Returns (B, P, C)."""
    b, h, w, c = img.shape
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat_img = img.reshape(b, h * w, c)

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()       # (B, P)
        vals = torch.gather(flat_img, 1, flat[..., None].expand(-1, -1, c))
        return vals * inb[..., None].to(img.dtype)

    v00 = corner(x0, y0)
    v01 = corner(x0 + 1, y0)
    v10 = corner(x0, y0 + 1)
    v11 = corner(x0 + 1, y0 + 1)
    wx = wx[..., None].to(img.dtype)
    wy = wy[..., None].to(img.dtype)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def dcnv3_coords(offset: torch.Tensor, kernel: int, stride: int, pad: int, dilation: int,
                 group: int, offset_scale: float = 1.0, row0: int = 0):
    """Sampling coordinates in padded-input pixels (JAX nn/dcn.py:dcnv3_coords):
    s = base + offset_scale·(grid + offset) − 0.5, kernel points X-major
    (p = ix·k + iy), output row i at global row row0 + i.
    offset (B, Ho, Wo, g·kk·2) -> sx, sy (B·g, Ho·Wo·kk)."""
    b, ho, wo = offset.shape[:3]
    kk = kernel * kernel
    f32 = dict(dtype=torch.float32, device=offset.device)
    half = (dilation * (kernel - 1)) // 2
    base_y = (torch.arange(ho, **f32) + row0) * stride + half + 0.5
    base_x = torch.arange(wo, **f32) * stride + half + 0.5
    vals = -half + torch.arange(kernel, **f32) * dilation
    kx2, ky2 = torch.meshgrid(vals, vals, indexing="ij")  # x varies on dim 0
    gx = kx2.reshape(kk)
    gy = ky2.reshape(kk)

    offs = offset.reshape(b, ho, wo, group, kk, 2)
    sx = base_x[None, None, :, None, None] + offset_scale * (gx + offs[..., 0]) - 0.5
    sy = base_y[None, :, None, None, None] + offset_scale * (gy + offs[..., 1]) - 0.5
    sxf = sx.permute(0, 3, 1, 2, 4).reshape(b * group, ho * wo * kk)
    syf = sy.permute(0, 3, 1, 2, 4).reshape(b * group, ho * wo * kk)
    return sxf, syf


def _narrow(t: torch.Tensor) -> bool:
    """A floating type below float32, which the plain versions compute in float32."""
    return t.dtype in (torch.bfloat16, torch.float16)


def dcnv3_core(x, offset, mask, kernel: int, stride: int, pad: int, dilation: int,
               group: int, group_channels: int, offset_scale: float,
               row0: int = 0) -> torch.Tensor:
    """Plain torch DCNv3 sampling (JAX nn/dcn.py:dcnv3_core): zero padding,
    per-group bilinear samples weighted by the mask and summed over kk; the
    output rows from global row `row0`. Below float32 it computes in float32
    and returns x's type, as JAX's kernel (kernels/dcn_sampling.py:173-262)."""
    if _narrow(x):
        return dcnv3_core(x.float(), offset.float(), mask.float(), kernel, stride, pad, dilation,
                          group, group_channels, offset_scale, row0).to(x.dtype)
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    hin, win = h + 2 * pad, w + 2 * pad
    ho, wo = offset.shape[1:3]
    kk = kernel * kernel
    sxf, syf = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale, row0)
    xg = xp.reshape(b, hin, win, group, group_channels).permute(0, 3, 1, 2, 4) \
        .reshape(b * group, hin, win, group_channels)
    samp = bilinear_sample_nhwc(xg, sxf, syf).reshape(b, group, ho, wo, kk, group_channels)
    m = mask.reshape(b, ho, wo, group, kk).permute(0, 3, 1, 2, 4)[..., None]
    out = (samp * m.to(samp.dtype)).sum(dim=4)                     # (b, g, ho, wo, gc)
    return out.permute(0, 2, 3, 1, 4).reshape(b, ho, wo, c)


def dcnv3_core_bwd(x, offset, mask, g_out, kernel: int, stride: int, pad: int, dilation: int,
                   group: int, group_channels: int, offset_scale: float, row0: int = 0):
    """Plain torch DCNv3 sampling gradients (JAX nn/dcn.py:dcnv3_core_bwd), in
    the dtype of x: (dx, doffset, dmask) for the output gradient `g_out`
    (B, Ho, Wo, C) of the output rows from global row `row0`; dx covers all of x.

    - dx: scatter-add of bilinear corner weight × mask × ḡ into the four
      corners of the padded input, cropped to the unpadded input;
    - doffset: ḡ·mask·∂sample/∂s, with ∂sample/∂sx = (1−wy)(v01−v00) +
      wy(v11−v10) (and likewise for y), times offset_scale = ∂s/∂offset;
    - dmask: ⟨sample, ḡ⟩ per kernel point.

    Below float32 it computes in float32 and returns each gradient in its
    input's type, as JAX's (nn/dcn.py:197-257)."""
    if _narrow(x):
        dx, doff, dmask = dcnv3_core_bwd(x.float(), offset.float(), mask.float(), g_out.float(),
                                         kernel, stride, pad, dilation, group, group_channels,
                                         offset_scale, row0)
        return dx.to(x.dtype), doff.to(offset.dtype), dmask.to(mask.dtype)
    b, h, w, c = x.shape
    gc = group_channels
    kk = kernel * kernel
    hin, win = h + 2 * pad, w + 2 * pad
    ho, wo = offset.shape[1:3]
    bg = b * group
    P = ho * wo * kk
    xg = F.pad(x, (0, 0, pad, pad, pad, pad)).reshape(b, hin, win, group, gc) \
        .permute(0, 3, 1, 2, 4).reshape(bg, hin * win, gc)
    sxf, syf = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale, row0)
    x0 = torch.floor(sxf)
    y0 = torch.floor(syf)
    wx = (sxf - x0).to(x.dtype)
    wy = (syf - y0).to(x.dtype)

    def corner(dy, dx):
        yi, xi = y0 + dy, x0 + dx
        inb = (xi >= 0) & (xi < win) & (yi >= 0) & (yi < hin)
        flat = (yi.clamp(0, hin - 1).long() * win + xi.clamp(0, win - 1).long())[..., None] \
            .expand(bg, P, gc)
        return torch.gather(xg, 1, flat) * inb[..., None], flat, inb

    v00, f00, i00 = corner(0, 0)
    v01, f01, i01 = corner(0, 1)   # +x
    v10, f10, i10 = corner(1, 0)   # +y
    v11, f11, i11 = corner(1, 1)
    w00, w01, w10, w11 = (1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy

    gk = g_out.reshape(b, ho, wo, group, gc).permute(0, 3, 1, 2, 4) \
        .reshape(bg, ho * wo, 1, gc).expand(bg, ho * wo, kk, gc).reshape(bg, P, gc)
    m = mask.reshape(b, ho, wo, group, kk).permute(0, 3, 1, 2, 4).reshape(bg, P)
    dsamp = gk * m[..., None]

    samp = v00 * w00[..., None] + v01 * w01[..., None] + v10 * w10[..., None] + v11 * w11[..., None]
    dmask_flat = (samp * gk).sum(-1)
    dd_dwx = (1 - wy)[..., None] * (v01 - v00) + wy[..., None] * (v11 - v10)
    dd_dwy = (1 - wx)[..., None] * (v10 - v00) + wx[..., None] * (v11 - v01)
    dsx = (dsamp * dd_dwx).sum(-1) * offset_scale
    dsy = (dsamp * dd_dwy).sum(-1) * offset_scale

    dxg = torch.zeros((bg, hin * win, gc), dtype=x.dtype, device=x.device)
    for flat, inb, wgt in ((f00, i00, w00), (f01, i01, w01), (f10, i10, w10), (f11, i11, w11)):
        dxg.scatter_add_(1, flat, dsamp * (wgt * inb)[..., None])
    dx = dxg.reshape(b, group, hin, win, gc).permute(0, 2, 3, 1, 4).reshape(b, hin, win, c)
    dx = dx[:, pad:hin - pad, pad:win - pad].contiguous()

    def unflat(t):  # (bg, P) -> (b, ho, wo, group, kk)
        return t.reshape(b, group, ho, wo, kk).permute(0, 2, 3, 1, 4)

    doff = torch.stack([unflat(dsx), unflat(dsy)], -1).reshape(b, ho, wo, group * kk * 2)
    dmask = unflat(dmask_flat).reshape(b, ho, wo, group * kk)
    return dx, doff.to(offset.dtype), dmask.to(mask.dtype)


def dcnv3_core_grid_sample(x, offset, mask, kernel: int, stride: int, pad: int, dilation: int,
                           group: int, group_channels: int, offset_scale: float) -> torch.Tensor:
    """The same function as the reference's dcnv3_core_pytorch computes it:
    F.grid_sample (bilinear, zero padding, align_corners=False) on the padded
    input, then the mask product and the sum over kk. A yardstick only."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    hin, win = h + 2 * pad, w + 2 * pad
    ho, wo = offset.shape[1:3]
    kk = kernel * kernel
    sxf, syf = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale)
    # pixel coordinate s (centers at integers) -> normalized (2s + 1) / size - 1
    grid = torch.stack([(2 * sxf + 1) / win - 1, (2 * syf + 1) / hin - 1], -1)
    inp = xp.reshape(b, hin, win, group, group_channels).permute(0, 3, 4, 1, 2) \
        .reshape(b * group, group_channels, hin, win)
    samp = F.grid_sample(inp, grid.reshape(b * group, ho * wo, kk, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=False)   # (b·g, gc, ho·wo, kk)
    m = mask.reshape(b, ho * wo, group, kk).permute(0, 2, 1, 3).reshape(b * group, 1, ho * wo, kk)
    out = (samp * m).sum(-1).reshape(b, group * group_channels, ho * wo)
    return out.transpose(1, 2).reshape(b, ho, wo, c)


def _check(x, offset, mask, kernel, stride, pad, dilation, group, group_channels, row0=0):
    # the kernels take float32 or bfloat16; the plain versions any one floating type
    cuda = x.device.type == "cuda"
    if (not x.is_floating_point() or {offset.dtype, mask.dtype} != {x.dtype}
            or cuda and x.dtype not in (torch.float32, torch.bfloat16)):
        want = "float32 or bfloat16" if cuda else "floating"
        raise TypeError(f"dcnv3_sampling expects {want} tensors of one type on {x.device.type}, "
                        f"got {x.dtype}, {offset.dtype}, {mask.dtype}")
    if x.ndim != 4 or offset.ndim != 4 or mask.ndim != 4:
        raise ValueError("dcnv3_sampling expects 4-D channels-last x, offset and mask")
    b, _, _, c = x.shape
    kk = kernel * kernel
    ho, wo = offset.shape[1:3]
    if c != group * group_channels:
        raise ValueError(f"x has {c} channels, not group·group_channels = {group}·{group_channels}")
    if tuple(offset.shape) != (b, ho, wo, group * kk * 2):
        raise ValueError(f"offset shape {tuple(offset.shape)}: expected (B, Ho, Wo, {group * kk * 2})")
    if tuple(mask.shape) != (b, ho, wo, group * kk):
        raise ValueError(f"mask shape {tuple(mask.shape)}: expected {(b, ho, wo, group * kk)}")
    rows = (x.shape[1] + 2 * pad - dilation * (kernel - 1) - 1) // stride + 1
    if row0 < 0 or (row0 > 0 and row0 + ho > rows):
        raise ValueError(f"output rows {row0} .. {row0 + ho - 1} outside the map's {rows}")
    if x.device.type in ("cpu", "meta"):
        return
    if x.device.type != "cuda":
        raise ValueError(f"dcnv3_sampling: unsupported device {x.device}")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError("dcnv3_sampling: x, offset and mask must be on one device")
    if not (x.is_contiguous() and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError("dcnv3_sampling expects contiguous channels-last tensors")


class DCNv3Plan(NamedTuple):
    """How csrc/dcnv3.cu and csrc/dcnv3_bwd.cu cut one call (csrc/dcnv3_common.cuh): a
    block owns a tile of th × tw output pixels of one image and group, and a window of
    the input of wh × ww pixels whose origin lies `win_off` pixels from the tile's
    origin times the stride (rows and columns alike); it takes the group's channels in
    chunks of `cc`, `cpb` chunks a block (the backward takes all of them). The
    window holds x; the backward sums each window pixel's dx in the tile's sample
    order before it goes into dx's fixed-point sums."""
    th: int
    tw: int
    cc: int
    cpb: int
    win_off: int
    wh: int
    ww: int
    shared_bytes: int
    blocks: int


SHARED_BYTES = 232448  # 227 KB, the most one block of an sm_90 card may take
BWD_STATIC_BYTES = 256  # the backward kernels' static shared memory (the scale), at most
BWD_PARTS = 2 * 132  # blocks of K3's first pass, each of which writes its share's maxima
SM_SHARED_BYTES = 233472  # 228 KB an SM, of which each resident block also holds 1 KB
SMS = 132  # streaming multiprocessors of an H100 SXM
TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))
WINDOW_MARGIN = 1  # px of the window beyond the tile's zero-offset footprint
CHUNK = {False: 128, True: 64}  # channels a chunk at most: forward (4 a lane), backward (2)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def dcnv3_window(th: int, tw: int, kernel: int, stride: int, pad: int, dilation: int,
                 offset_scale: float, margin: int = WINDOW_MARGIN):
    """(win_off, wh, ww) of a th × tw tile: its zero-offset samples span
    ±ext = ceil(|offset_scale|·half) px about each tap's centre (capped at 16, as
    the window only places corners and any offset stays exact), plus the +1
    bilinear corner and `margin` px on every side."""
    half = dilation * (kernel - 1) // 2
    scale = abs(offset_scale) if math.isfinite(offset_scale) else 1.0
    ext = min(math.ceil(scale * half), 16)
    span = 2 * ext + 2 + 2 * margin
    return half - pad - ext - margin, (th - 1) * stride + span, (tw - 1) * stride + span


def blocks_per_sm(shared_bytes: int) -> int:
    """Blocks of `shared_bytes` that one SM holds at once, by shared memory."""
    return SM_SHARED_BYTES // (shared_bytes + 1024)


@functools.lru_cache(maxsize=512)
def dcnv3_plan(b: int, ho: int, wo: int, group: int, group_channels: int, kernel: int,
               stride: int, pad: int, dilation: int, offset_scale: float,
               backward: bool, margin: int = WINDOW_MARGIN, itemsize: int = 4) -> DCNv3Plan:
    """The launch plan of one DCNv3 call, cached per shape. Chunks of up to
    `CHUNK` channels, lanes along them; a window margin of `margin` px.
    The first tile of `TILES` wins whose block leaves room for four blocks an
    SM and whose grid gives the forward four blocks an SM (it may spread a
    group's chunks over blocks, and at tiles of 2 x 2 halve its chunks, to get
    there), failing that two, and the backward two (it may not spread them:
    its doffset and dmask sum over all the group's channels in one block);
    failing that, the plan with the most blocks. A forward call too small to
    fill one such wave (batch 1) takes tiles of at most 4 x 4 and chunks of at
    most 64 channels, each chunk in a block of its own. PERF.md compares these
    picks with kernels/bench_dcnv3.py's grid. The forward sizes its window by
    `itemsize`, x's bytes an element (a forward's output does not depend on
    its plan); the backward always by float32's: its tile orders dx's float32
    sums, so a bfloat16 call takes the float32 call's plan and its outputs are
    the float32 call's, rounded."""
    size = 4 if backward else itemsize
    kk = kernel * kernel
    # chunks of CHUNK channels on tiles down to 2 x 2 first; the forward then halves its
    # chunks, spread over blocks, before the tiles shrink further
    ccs = [min(group_channels, CHUNK[backward])]
    while not backward and ccs[-1] > 32:
        ccs.append(ccs[-1] // 2)
    order = [(tile, cc) for cc in ccs for tile in TILES[:-2]] + [(t, ccs[-1]) for t in TILES[-2:]]
    fits = []
    for (th, tw), cc in order:
        win_off, wh, ww = dcnv3_window(th, tw, kernel, stride, pad, dilation, offset_scale,
                                       margin)
        shared = dcnv3_shared_bytes(th, tw, kk, cc, wh, ww, backward, size)
        if shared > SHARED_BYTES:
            continue
        tiles = b * group * -(-ho // th) * -(-wo // tw)
        n_chunks = -(-group_channels // cc)
        for cpb in ((n_chunks,) if backward else (n_chunks, 1)):
            fits.append(DCNv3Plan(th, tw, cc, cpb, win_off, wh, ww, shared,
                                  tiles * -(-n_chunks // cpb)))
    if not backward and b * group * ho * wo * group_channels <= 4 * SMS * 16 * 64:
        # a call too small for one wave of four 4 x 4 x 64 blocks an SM (batch 1): its blocks
        # are mostly latency, and small ones spread it over the most SMs
        small = [plan for plan in fits if plan.th * plan.tw <= 16 and plan.cc <= 64
                 and plan.cpb == 1]
        if small:
            return small[0]
    for per_sm in ((2,) if backward else (4, 2)):
        for plan in fits:
            if blocks_per_sm(plan.shared_bytes) >= 4 and plan.blocks >= per_sm * SMS:
                return plan
    if not fits:
        raise ValueError(f"dcnv3: no launch plan fits {SHARED_BYTES} bytes of shared memory "
                         f"(kernel {kernel}, stride {stride}, dilation {dilation})")
    return max(fits, key=lambda plan: plan.blocks)


def dcnv3_shared_bytes(th: int, tw: int, kk: int, cc: int, wh: int, ww: int,
                       backward: bool, itemsize: int = 4) -> int:
    """Shared memory of one block, as the launchers compute it: the tile's
    samples (16 bytes each, plus 8 for their corner) and the window's x
    (`itemsize` bytes an element); in the backward also the samples' four sums
    and their four products mask · w (16 bytes each), the tile's output
    gradient in float32, the samples' lists by the cell of their top-left
    corner (each sample once and each of the (wh + 1)(ww + 1) cells twice, 4
    bytes each) and the static scale (BWD_STATIC_BYTES). The geometry and the
    window are 16-byte aligned."""
    n = th * tw * kk
    geometry = 16 * n + _align16(8 * n)
    if backward:
        cells = (wh + 1) * (ww + 1)
        return (geometry + 32 * n + _align16(wh * ww * cc * itemsize) + th * tw * cc * 4
                + 4 * (n + 2 * cells + 1) + BWD_STATIC_BYTES)
    return geometry + wh * ww * cc * itemsize


def dcnv3_window_escapes(offset: torch.Tensor, h: int, w: int, kernel: int, stride: int,
                         pad: int, dilation: int, group: int, offset_scale: float,
                         plan: DCNv3Plan, row0: int = 0) -> float:
    """Share of the samples of a call with a corner outside their block's
    window: those the kernels read (and the backward adds to) in device memory.
    A block's window follows its tile's global rows (from `row0`), so the plan
    of a band is the plan of any map of its shape."""
    b, ho, wo = offset.shape[:3]
    sx, sy = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale, row0)
    shape = (b * group, ho, wo, kernel * kernel)
    y0 = torch.floor(sy).reshape(shape) - pad
    x0 = torch.floor(sx).reshape(shape) - pad
    dev = dict(device=offset.device)
    wy0 = ((torch.arange(ho, **dev) // plan.th * plan.th + row0) * stride
           + plan.win_off)[:, None, None]
    wx0 = (torch.arange(wo, **dev) // plan.tw * plan.tw * stride + plan.win_off)[None, :, None]
    out = (y0 < wy0) | (y0 + 1 >= wy0 + plan.wh) | (x0 < wx0) | (x0 + 1 >= wx0 + plan.ww)
    return out.float().mean().item()


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the launchers' type codes


def _launch(fn, ptrs, x, offset, kernel, stride, pad, dilation, group, group_channels,
            offset_scale, row0=0, plan=None):
    """Launch `fn` on `ptrs` with the cached plan of its shape, or with `plan`
    (kernels/bench_dcnv3.py and chip_smoke.py time other plans)."""
    launch, error_string = _BOUND.get(fn) or _bind(fn)
    b, h, w, c = x.shape
    ho, wo = offset.shape[1:3]
    backward = fn == "dcnv3_backward_launch"
    if plan is None:
        plan = dcnv3_plan(b, ho, wo, group, group_channels, kernel, stride, pad, dilation,
                          offset_scale, backward, itemsize=x.element_size())
    args = (*(t.data_ptr() for t in ptrs), b, h, w, c, ho, wo, group, group_channels, kernel,
            stride, pad, dilation, row0, offset_scale, *plan[:7], _DTYPES[x.dtype],
            *((BWD_PARTS,) if backward else ()))
    if x.device.index == torch.cuda.current_device():
        rc = launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            rc = launch(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{fn} failed: {error_string(rc).decode()}")


def _backward(x, offset, mask, grad_out, cfg, plan=None):
    """K3 on CUDA tensors: (dx, doffset, dmask), each in its input's type, with
    the fixed-point sums of dx (one int64 an element) and the first pass's
    maxima as scratch; `plan` as `_launch`'s."""
    dx, doffset, dmask = torch.empty_like(x), torch.empty_like(offset), torch.empty_like(mask)
    sums = torch.empty(x.shape, dtype=torch.int64, device=x.device)  # zeroed by the first pass
    part = torch.empty(2 * BWD_PARTS, dtype=torch.float32, device=x.device)
    _launch("dcnv3_backward_launch", (x, offset, mask, grad_out, dx, doffset, dmask, sums, part),
            x, offset, *cfg, plan=plan)
    return dx, doffset, dmask


def _forward(x, offset, mask, cfg):
    if x.device.type in ("cpu", "meta"):
        return dcnv3_core(x, offset, mask, *cfg)
    out = torch.empty((x.shape[0], *offset.shape[1:3], x.shape[3]), dtype=x.dtype,
                      device=x.device)
    _launch("dcnv3_sampling_launch", (x, offset, mask, out), x, offset, *cfg)
    dcnv3_sampling.launches += 1
    return out


class _DCNv3Sampling(torch.autograd.Function):
    """The sampling with its gradient: K2 forward and K3 backward on CUDA, the
    plain versions on the CPU (JAX kernels/dcn_sampling.py:111-150)."""

    @staticmethod
    def forward(ctx, x, offset, mask, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, offset, mask)
        return _forward(x, offset, mask, cfg)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask = ctx.saved_tensors
        dx, doffset, dmask = dcnv3_sampling_backward(x, offset, mask, grad_out.contiguous(),
                                                     *ctx.cfg)
        return dx, doffset, dmask, None


def dcnv3_sampling(x, offset, mask, kernel: int, stride: int, pad: int, dilation: int,
                   group: int, group_channels: int, offset_scale: float,
                   row0: int = 0) -> torch.Tensor:
    """DCNv3 sampling, (B, H, W, C) -> (B, Ho, Wo, C), with Ho and Wo those of
    `offset`, its first row global row `row0`, differentiable in x, offset and
    mask. On CUDA tensors the forward launches csrc/dcnv3.cu (counted in
    `dcnv3_sampling.launches`) and the backward `dcnv3_sampling_backward`; on
    CPU or meta tensors they are the plain `dcnv3_core` and `dcnv3_core_bwd`."""
    _check(x, offset, mask, kernel, stride, pad, dilation, group, group_channels, row0)
    cfg = (kernel, stride, pad, dilation, group, group_channels, float(offset_scale), int(row0))
    return _DCNv3Sampling.apply(x, offset, mask, cfg)


dcnv3_sampling.launches = 0


def dcnv3_sampling_backward(x, offset, mask, grad_out, kernel: int, stride: int, pad: int,
                            dilation: int, group: int, group_channels: int,
                            offset_scale: float, row0: int = 0):
    """(dx, doffset, dmask) of DCNv3 sampling for the output gradient
    `grad_out` (B, Ho, Wo, C) of the output rows from global row `row0`; dx
    covers all of x, each gradient in its input's type. On CUDA tensors this
    launches csrc/dcnv3_bwd.cu (its three kernels, one call) and counts the
    call in `dcnv3_sampling_backward.launches`; the same inputs give the same
    bits on every call. On CPU tensors it runs `dcnv3_core_bwd`."""
    _check(x, offset, mask, kernel, stride, pad, dilation, group, group_channels, row0)
    want = (x.shape[0], *offset.shape[1:3], x.shape[3])
    if tuple(grad_out.shape) != want or grad_out.dtype != x.dtype or grad_out.device != x.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} on {grad_out.device}: "
                         f"expected {want} {x.dtype} on {x.device}")
    cfg = (kernel, stride, pad, dilation, group, group_channels, offset_scale, row0)
    if x.device.type == "cpu":
        return dcnv3_core_bwd(x, offset, mask, grad_out, *cfg)
    if x.device.type != "cuda":
        raise ValueError(f"dcnv3_sampling_backward: unsupported device {x.device}")
    if not grad_out.is_contiguous():
        raise ValueError("dcnv3_sampling_backward expects a contiguous grad_out")
    out = _backward(x, offset, mask, grad_out, cfg)
    dcnv3_sampling_backward.launches += 1
    return out


dcnv3_sampling_backward.launches = 0

# launch function -> (source in csrc/, pointer arguments, trailing int arguments (the type code;
# the backward's first-pass blocks), error-string function)
_KERNELS = {"dcnv3_sampling_launch": ("dcnv3", 4, 1, "dcnv3_error_string"),
            "dcnv3_backward_launch": ("dcnv3_bwd", 9, 2, "dcnv3_backward_error_string")}
_BOUND: dict = {}  # launch function -> (launch, error string), bound once


def _bind(fn: str):
    """Build and load `fn`'s library at first use and bind its two functions;
    later calls find them in `_BOUND` without taking the build's locks."""
    from yolo_dual_tpu_torch.kernels.build import load_library
    name, n_ptr, n_tail, err = _KERNELS[fn]
    lib = load_library(name)
    launch, error_string = getattr(lib, fn), getattr(lib, err)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch.argtypes = [p] * n_ptr + [i] * 13 + [ctypes.c_float] + [i] * (7 + n_tail) + [p]
    launch.restype = ctypes.c_int
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    _BOUND[fn] = launch, error_string
    return _BOUND[fn]
