"""DCNv3 deformable sampling (port of yolo_dual_tpu/kernels/dcn_sampling.py and
of the sampling core in yolo_dual_tpu/nn/dcn.py).

`dcnv3_sampling` launches the hand-written CUDA kernel csrc/dcnv3.cu on CUDA
tensors and runs the plain torch version, `dcnv3_core`, on CPU tensors (and on
meta tensors, which carry shapes only: the model's stride probe runs on them).
All tensors are channels-last, as in the JAX package: x (B, H, W, C = g·gc), offset
(B, Ho, Wo, g·kk·2) as (Δx, Δy) pairs, mask (B, Ho, Wo, g·kk) softmaxed over kk;
the output is (B, Ho, Wo, C). The kernel takes float32; the plain version any
one floating type (float64 for a CPU reference).

The kernel is forward only. Its backward (the JAX package's second DCNv3 Pallas
kernel) is not ported yet, so on CUDA `dcnv3_sampling` raises when a gradient
would be needed instead of returning an output without one.

`dcnv3_core_grid_sample` is the reference's grid_sample formulation of the same
function; chip_smoke.py times it as a yardstick and nothing in the package
calls it.
"""

from __future__ import annotations

import ctypes

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
                 group: int, offset_scale: float = 1.0):
    """Sampling coordinates in padded-input pixels (JAX nn/dcn.py:dcnv3_coords):
    s = base + offset_scale·(grid + offset) − 0.5, kernel points X-major
    (p = ix·k + iy). offset (B, Ho, Wo, g·kk·2) -> sx, sy (B·g, Ho·Wo·kk)."""
    b, ho, wo = offset.shape[:3]
    kk = kernel * kernel
    f32 = dict(dtype=torch.float32, device=offset.device)
    half = (dilation * (kernel - 1)) // 2
    base_y = torch.arange(ho, **f32) * stride + half + 0.5
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


def dcnv3_core(x, offset, mask, kernel: int, stride: int, pad: int, dilation: int,
               group: int, group_channels: int, offset_scale: float) -> torch.Tensor:
    """Plain torch DCNv3 sampling (JAX nn/dcn.py:dcnv3_core): zero padding,
    per-group bilinear samples weighted by the mask and summed over kk."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    hin, win = h + 2 * pad, w + 2 * pad
    ho, wo = offset.shape[1:3]
    kk = kernel * kernel
    sxf, syf = dcnv3_coords(offset, kernel, stride, pad, dilation, group, offset_scale)
    xg = xp.reshape(b, hin, win, group, group_channels).permute(0, 3, 1, 2, 4) \
        .reshape(b * group, hin, win, group_channels)
    samp = bilinear_sample_nhwc(xg, sxf, syf).reshape(b, group, ho, wo, kk, group_channels)
    m = mask.reshape(b, ho, wo, group, kk).permute(0, 3, 1, 2, 4)[..., None]
    out = (samp * m.to(samp.dtype)).sum(dim=4)                     # (b, g, ho, wo, gc)
    return out.permute(0, 2, 3, 1, 4).reshape(b, ho, wo, c)


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


def _check(x, offset, mask, kernel, group, group_channels):
    # the kernel takes float32; the plain version any one floating type
    want = torch.float32 if x.device.type == "cuda" else x.dtype
    if not x.is_floating_point() or {offset.dtype, mask.dtype, x.dtype} != {want}:
        raise TypeError(f"dcnv3_sampling expects {'float32' if want == torch.float32 else want} "
                        f"tensors on {x.device.type}, got {x.dtype}, {offset.dtype}, {mask.dtype}")
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


def dcnv3_sampling(x, offset, mask, kernel: int, stride: int, pad: int, dilation: int,
                   group: int, group_channels: int, offset_scale: float) -> torch.Tensor:
    """DCNv3 sampling, (B, H, W, C) -> (B, Ho, Wo, C), with Ho and Wo those of
    `offset`. On a CUDA tensor this launches csrc/dcnv3.cu and counts the
    launch in `dcnv3_sampling.launches`; on a CPU or meta tensor it runs
    `dcnv3_core`."""
    _check(x, offset, mask, kernel, group, group_channels)
    if x.device.type in ("cpu", "meta"):
        return dcnv3_core(x, offset, mask, kernel, stride, pad, dilation, group,
                          group_channels, offset_scale)
    if x.device.type != "cuda":
        raise ValueError(f"dcnv3_sampling: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or offset.requires_grad or mask.requires_grad):
        raise NotImplementedError(
            "dcnv3_sampling on CUDA is forward only: its backward kernel (the port of "
            "yolo_dual_tpu/kernels/dcn_sampling.py:_dcnv3_banded_bwd) is not written yet; "
            "run under torch.no_grad() or torch.inference_mode()")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError("dcnv3_sampling: x, offset and mask must be on one device")
    if not (x.is_contiguous() and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError("dcnv3_sampling expects contiguous channels-last tensors")
    b, h, w, c = x.shape
    ho, wo = offset.shape[1:3]
    out = torch.empty((b, ho, wo, c), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.dcnv3_sampling_launch(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, w, c, ho, wo, group, group_channels, kernel, stride, pad, dilation,
            float(offset_scale), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"dcnv3_sampling kernel launch failed: {lib.dcnv3_error_string(rc).decode()}")
    dcnv3_sampling.launches += 1
    return out


dcnv3_sampling.launches = 0


def _library() -> ctypes.CDLL:
    from yolo_dual_tpu_torch.kernels.build import load_library
    lib = load_library("dcnv3")
    if lib.dcnv3_sampling_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dcnv3_sampling_launch.argtypes = [p, p, p, p] + [i] * 12 + [ctypes.c_float, p]
        lib.dcnv3_sampling_launch.restype = ctypes.c_int
        lib.dcnv3_error_string.argtypes = [ctypes.c_int]
        lib.dcnv3_error_string.restype = ctypes.c_char_p
    return lib
