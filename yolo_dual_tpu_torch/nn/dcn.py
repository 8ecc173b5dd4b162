"""Deformable convolutions (port of yolo_dual_tpu/nn/dcn.py).

DCNv2 (reference models/common.py:1629-1710, torchvision's deform_conv2d;
C2f_DCN from the reference's yolov8 script): `deform_conv2d_v2` and its plain
`deform_conv2d_v2_reference`, `DCNv2`, `Bottleneck_DCN`, `C3_DCN`, `C2f_DCN`.
In JAX this is jax.lax, not Pallas, so it runs as torch ops here: the
bilinear sampling is an autograd Function that keeps only its inputs for the
backward and recomputes the corners there, and the product with the weight
is one matmul.

DCNv3 (reference models/ops_dcnv3 modules/dcnv3.py and the YOLO glue
"common and yolo.py"): `DCNv3` is channels-last, as in the JAX package and
the reference; the port's graph is NCHW, so `DCNV3_YoLo` permutes around it as
the reference does. Its sampling and gradient, with the plain `dcnv3_coords`,
`dcnv3_core` and `dcnv3_core_bwd` they are held against, are in
kernels/dcn_sampling.py: the CUDA kernels on the card, the plain versions on
the CPU.

Attribute names follow the JAX variable tree (`conv_offset_mask`, `weight`,
`bn`; C2f_DCN's `m_{i}_pre`, `m_{i}_offset`, `m_{i}_dcn_weight`, `m_{i}_bn`;
`cv2.dcnv3.{input_proj,dw_conv,offset,mask,output_proj}`), so weights carried
by io/weights.py:state_dict_from_flax load with `strict=True`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
from yolo_dual_tpu_torch.nn.activations import resolve_act
from yolo_dual_tpu_torch.nn.common import BN_EPS, BN_MOMENTUM, C3, BatchNorm2d, Conv
from yolo_dual_tpu_torch.parallel import spatial

# ---------------------------------------------------------------------------
# DCNv2: torchvision's deform_conv2d (JAX nn/dcn.py:37-111)
# ---------------------------------------------------------------------------


def _dcnv2_points(offset, kh: int, kw: int, stride: int, pad: int, dil: int, dg: int):
    """Sampling points in pixel coordinates (integers hit pixel centres), as
    JAX computes them (nn/dcn.py:90-99): s = o·stride − pad + k·dil + Δ, from a
    channels-last offset (B, Ho, Wo, dg·kk·2) whose channels [2p], [2p+1] are
    Δy, Δx of point p = g·kk + k. Returns sy, sx of shape (B, Ho, Wo, kk, dg)."""
    b, ho, wo = offset.shape[:3]
    kk = kh * kw
    offs = offset.reshape(b, ho, wo, dg, kk, 2).transpose(3, 4)
    dt, dev = offset.dtype, offset.device
    oy = torch.arange(ho, dtype=dt, device=dev) * stride - pad
    ox = torch.arange(wo, dtype=dt, device=dev) * stride - pad
    ky, kx = torch.meshgrid(torch.arange(kh, dtype=dt, device=dev) * dil,
                            torch.arange(kw, dtype=dt, device=dev) * dil, indexing="ij")
    sy = oy[:, None, None, None] + ky.reshape(kk, 1) + offs[..., 0]
    sx = ox[None, :, None, None] + kx.reshape(kk, 1) + offs[..., 1]
    return sy, sx


def _dcnv2_corners(sy, sx, h: int, w: int):
    """The four bilinear corners of every point: for each, the flat row index
    into the channels-last input viewed as (B·H·W·dg, C/dg) (clamped), its
    in-bounds factor (zero padding corner by corner), the weight's y and x
    factors and the signs of their derivatives. Yields
    (rows, inb, fy, fx, sign_y, sign_x); the weights wy = sy − floor(sy) and
    wx likewise."""
    b, _, _, _, dg = sy.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    bi = torch.arange(b, device=sy.device).view(b, 1, 1, 1, 1)
    gi = torch.arange(dg, device=sy.device)
    for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + cy, x0 + cx
        inb = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(sy.dtype)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        rows = ((bi * h + yc) * w + xc) * dg + gi
        yield (rows, inb, wy if cy else 1 - wy, wx if cx else 1 - wx,
               1.0 if cy else -1.0, 1.0 if cx else -1.0)


def _gather(xr, rows):
    return xr.index_select(0, rows.reshape(-1)).view(*rows.shape, xr.shape[-1])


class _DeformSample(torch.autograd.Function):
    """The bilinear samples of DCNv2, masked: x (B, H, W, C) channels-last,
    offset (B, Ho, Wo, dg·kk·2), mask (B, Ho, Wo, dg·kk) or None (all ones) ->
    (B, Ho, Wo, kk, C). It keeps only its inputs for the backward, which
    recomputes the corners: dx by scatter-adds (`index_add_`), the offset's
    gradient from the corner differences, (1−wy)(v01−v00) + wy(v11−v10) in x
    and its twin in y (the derivation of JAX's dcnv3_core_bwd,
    nn/dcn.py:174), and the mask's as the unmasked sample's product with the
    incoming gradient."""

    @staticmethod
    def forward(ctx, x, offset, mask, kh, kw, stride, pad, dil, dg):
        b, h, w, c = x.shape
        sy, sx = _dcnv2_points(offset, kh, kw, stride, pad, dil, dg)
        xr = x.reshape(-1, c // dg)
        v = [(_gather(xr, rows) * inb[..., None], fx[..., None])
             for rows, inb, _, fx, _, _ in _dcnv2_corners(sy, sx, h, w)]
        wy = (sy - torch.floor(sy))[..., None]
        # JAX's order: a row's two corners blended in x, then the rows in y
        top = v[0][0] * v[0][1] + v[1][0] * v[1][1]
        bot = v[2][0] * v[2][1] + v[3][0] * v[3][1]
        del v
        out = top * (1 - wy) + bot * wy
        if mask is not None:
            m = mask.reshape(b, *mask.shape[1:3], dg, kh * kw).transpose(3, 4)
            out = out * m[..., None]
        ctx.save_for_backward(x, offset, mask)
        ctx.conf = (kh, kw, stride, pad, dil, dg)
        return out.reshape(*out.shape[:3], kh * kw, c)

    @staticmethod
    def backward(ctx, grad):
        x, offset, mask = ctx.saved_tensors
        kh, kw, stride, pad, dil, dg = ctx.conf
        b, h, w, c = x.shape
        sy, sx = _dcnv2_points(offset, kh, kw, stride, pad, dil, dg)
        g = grad.reshape(*sy.shape, c // dg)
        m = (mask.reshape(b, *mask.shape[1:3], dg, kh * kw).transpose(3, 4)
             if mask is not None else None)
        xr = x.reshape(-1, c // dg)
        need_x, need_off, need_mask = ctx.needs_input_grad[:3]
        dxr = torch.zeros_like(xr) if need_x else None
        dsy = torch.zeros_like(sy) if need_off else None
        dsx = torch.zeros_like(sx) if need_off else None
        dm = torch.zeros_like(sy) if need_mask and m is not None else None
        for rows, inb, fy, fx, sgy, sgx in _dcnv2_corners(sy, sx, h, w):
            if need_off or dm is not None:
                dot = (g * _gather(xr, rows)).sum(-1) * inb  # <incoming grad, corner value>
                if need_off:
                    dsy += sgy * fx * dot
                    dsx += sgx * fy * dot
                if dm is not None:
                    dm += fy * fx * dot
            if need_x:
                coef = fy * fx * inb if m is None else fy * fx * inb * m
                dxr.index_add_(0, rows.reshape(-1), (g * coef[..., None]).reshape(-1, c // dg))
        doff = dmask = None
        if need_off:
            if m is not None:
                dsy, dsx = dsy * m, dsx * m
            doff = torch.stack([dsy, dsx], -1).transpose(3, 4).reshape(offset.shape)
        if dm is not None:
            dmask = dm.transpose(3, 4).reshape(mask.shape)
        dx = dxr.view(x.shape) if need_x else None
        return dx, doff, dmask, None, None, None, None, None, None


def _dcnv2_product(samp, weight, bias, groups: int):
    """(B, Ho, Wo, kk, Cin) samples times an OIHW weight (Cout, Cin/groups,
    kh, kw), plus bias -> (B, Cout, Ho, Wo): JAX's einsum
    "bhwkc,kco->bhwo" and its grouped branch (nn/dcn.py:102-111)."""
    b, ho, wo, kk, cin = samp.shape
    cout = weight.shape[0]
    if groups == 1:
        out = samp.reshape(-1, kk * cin) @ weight.permute(2, 3, 1, 0).reshape(kk * cin, cout)
    else:
        cg, og = cin // groups, cout // groups
        wg = weight.reshape(groups, og, cg, kk).permute(0, 3, 2, 1)  # (g, kk, cg, og)
        out = torch.einsum("nkgc,gkco->ngo", samp.reshape(-1, kk, groups, cg), wg)
        out = out.reshape(-1, cout)
    if bias is not None:
        out = out + bias
    return out.view(b, ho, wo, cout).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1).contiguous()


def deform_conv2d_v2(x, offset, mask, weight, bias=None, stride: int = 1, padding: int = 1,
                     dilation: int = 1, groups: int = 1, deformable_groups: int = 1):
    """torchvision's deform_conv2d, as JAX's `deform_conv2d_v2` states it
    (nn/dcn.py:65), on NCHW tensors: x (B, Cin, H, W); offset (B, dg·kk·2,
    Ho, Wo) with channels [2p] = Δy, [2p+1] = Δx for p = g·kk + k; mask (B,
    dg·kk, Ho, Wo) already sigmoided, or None for all ones; weight OIHW
    (Cout, Cin/groups, kh, kw); bias (Cout,) or None. Sample points are
    s = o·stride − pad + k·dil + Δ in pixel coordinates, floored as JAX does
    (no grid_sample round trip: an integer point stays integer); corners
    outside the map read zero. The sampling is `_DeformSample`; the
    product one matmul. Float16/bfloat16 inputs are sampled in float32."""
    kh, kw = weight.shape[-2:]
    dt = x.dtype
    if dt in (torch.float16, torch.bfloat16):
        x, offset = x.float(), offset.float()
        mask = None if mask is None else mask.float()
    samp = _DeformSample.apply(_nhwc(x), _nhwc(offset), _nhwc(mask), kh, kw, stride, padding,
                               dilation, deformable_groups)
    return _dcnv2_product(samp.to(dt), weight, bias, groups)


def deform_conv2d_v2_reference(x, offset, mask, weight, bias=None, stride: int = 1,
                               padding: int = 1, dilation: int = 1, groups: int = 1,
                               deformable_groups: int = 1):
    """The plain version of `deform_conv2d_v2`, line for line JAX's
    (`bilinear_sample_nhwc` and `deform_conv2d_v2`, nn/dcn.py:37-111):
    gathers whose gradients autograd derives. The tests hold the autograd
    Function and its backward against it."""
    b, cin, h, w = x.shape
    kh, kw = weight.shape[-2:]
    dg = deformable_groups
    xn, off = _nhwc(x), _nhwc(offset)
    sy, sx = _dcnv2_points(off, kh, kw, stride, padding, dilation, dg)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    xr = xn.reshape(-1, cin // dg)
    bi = torch.arange(b, device=x.device).view(b, 1, 1, 1, 1)
    gi = torch.arange(dg, device=x.device)

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        rows = ((bi * h + yi.clamp(0, h - 1).long()) * w + xi.clamp(0, w - 1).long()) * dg + gi
        return _gather(xr, rows) * inb[..., None].to(x.dtype)

    top = corner(x0, y0) * (1 - wx) + corner(x0 + 1, y0) * wx
    bot = corner(x0, y0 + 1) * (1 - wx) + corner(x0 + 1, y0 + 1) * wx
    samp = top * (1 - wy) + bot * wy
    if mask is not None:
        samp = samp * _nhwc(mask).reshape(*sy.shape[:3], dg, kh * kw).transpose(3, 4)[..., None]
    return _dcnv2_product(samp.reshape(*sy.shape[:3], kh * kw, cin), weight, bias, groups)


class DCNv2(nn.Module):
    """Deformable conv v2 block (JAX nn/dcn.py:265; reference
    models/common.py:1629-1692): `conv_offset_mask` (zero-initialised) gives
    the offsets, channels [:2·dg·kk], and the mask, sigmoid of the rest; the
    deformable conv with `weight` (OIHW) and `bias`; BatchNorm `bn` and the
    activation. `fuse()` leaves `bn` alone, as JAX's fuse_conv_bn does: it
    sits beside no conv `kernel`."""

    def __init__(self, c1, c2, k=3, s=1, p=1, g=1, d=1, deformable_groups=1, act=True):
        super().__init__()
        self.k, self.s, self.p, self.g, self.d = k, s, p, g, d
        self.deformable_groups = deformable_groups
        self.conv_offset_mask = nn.Conv2d(c1, deformable_groups * 3 * k * k, k, s, p, bias=True)
        self.weight = nn.Parameter(torch.empty(c2, c1 // g, k, k))
        self.bias = nn.Parameter(torch.empty(c2))
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = resolve_act(act)

    def forward(self, x):
        n = 2 * self.deformable_groups * self.k * self.k
        om = self.conv_offset_mask(x)
        y = deform_conv2d_v2(x, om[:, :n], torch.sigmoid(om[:, n:]), self.weight, self.bias,
                             self.s, self.p, self.d, self.g, self.deformable_groups)
        return self.act(self.bn(y))


class Bottleneck_DCN(nn.Module):
    """Bottleneck whose second conv is DCNv2 (JAX nn/dcn.py:308)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = DCNv2(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3_DCN(C3):
    """C3 with Bottleneck_DCN inners (JAX nn/dcn.py:325; reference
    models/common.py:1706-1710). The inners keep their own SiLU, as in JAX."""

    def inner(self, c_, n, shortcut, g, act):
        return [Bottleneck_DCN(c_, c_, shortcut, g, e=1.0) for _ in range(n)]


class C2f_DCN(nn.Module):
    """C2f whose inner blocks are a 3x3 Conv (`m_{i}_pre`, no activation), an
    offset Conv with SiLU (`m_{i}_offset`, 18 channels), a deformable conv
    with an all-ones mask and no bias (`m_{i}_dcn_weight`), BatchNorm
    (`m_{i}_bn`) and SiLU (JAX nn/dcn.py:333; reference
    yolov8/seg_jaccardloss_yolov8.py:431-457)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, act=True):
        super().__init__()
        c = int(c2 * e)
        self.c, self.n, self.g = c, n, g
        self.cv1 = Conv(c1, 2 * c, 1, 1, act=act)
        for i in range(n):
            setattr(self, f"m_{i}_pre", Conv(c, c, 3, 1, g=g, act=False))
            setattr(self, f"m_{i}_offset", Conv(c, 2 * 9, 3, 1, g=g, act=True))
            setattr(self, f"m_{i}_dcn_weight", nn.Parameter(torch.empty(c, c // g, 3, 3)))
            setattr(self, f"m_{i}_bn", BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM))
        self.cv2 = Conv((2 + n) * c, c2, 1, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            z = getattr(self, f"m_{i}_pre")(ys[-1])
            off = getattr(self, f"m_{i}_offset")(z)
            z = deform_conv2d_v2(z, off, None, getattr(self, f"m_{i}_dcn_weight"), None, 1, 1, 1,
                                 self.g, 1)
            ys.append(F.silu(getattr(self, f"m_{i}_bn")(z)))
        out = self.cv2(torch.cat(ys, 1))
        return out + x if self.add else out


# ---------------------------------------------------------------------------
# DCNv3
# ---------------------------------------------------------------------------


class DCNv3(nn.Module):
    """InternImage DCNv3 (JAX nn/dcn.py:DCNv3): input_proj; a depthwise
    Conv + BN + SiLU feeding the linear offset and mask heads; the mask
    softmaxed in float32 over the kk points of each group; deformable
    sampling; output_proj. (B, H, W, C) -> (B, Ho, Wo, C). Inside
    parallel/spatial.py:spatial, on the rank's band of rows: dw_conv
    exchanges its halo (a Conv), the per-pixel layers stay local, and the
    sampling takes input_proj's output gathered over the space group and
    samples the band's output rows at their global rows (`row0`; JAX
    nn/dcn.py:366-400 under XLA's partitioner)."""

    def __init__(self, channels, kernel_size=3, stride=1, pad=1, dilation=1, group=1,
                 offset_scale=1.0):
        super().__init__()
        if channels % group:
            raise ValueError(f"DCNv3: {channels} channels do not split into {group} groups")
        c, k = channels, kernel_size
        self.kernel_size, self.stride, self.pad = k, stride, pad
        self.dilation, self.group, self.offset_scale = dilation, group, offset_scale
        self.group_channels = c // group
        kk = k * k
        self.input_proj = nn.Linear(c, c)
        self.dw_conv = Conv(c, c, k, 1, g=c)
        self.offset = nn.Linear(c, group * kk * 2)
        self.mask = nn.Linear(c, group * kk)
        self.output_proj = nn.Linear(c, c)

    def forward(self, x):
        g, kk = self.group, self.kernel_size ** 2
        proj = self.input_proj(x).contiguous()
        x1 = self.dw_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        offset = self.offset(x1).contiguous()
        mask = self.mask(x1)
        b, h, w, _ = mask.shape
        mask = mask.reshape(b, h, w, g, kk).float().softmax(-1).reshape(b, h, w, g * kk)
        mask = mask.to(proj.dtype)
        # the sampling runs in float32, as JAX's kernels compute
        # (kernels/dcn_sampling.py:321-329): under autocast the bfloat16 projections are
        # converted here, at the autograd Function's boundary, and their gradients back
        proj, offset, mask = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
                              for t in (proj, offset, mask))
        band = ()
        if spatial.space_mesh() is not None:  # the band's rows, sampled in the whole map
            band = (spatial.space_mesh().space_rank * h,)  # row0
            proj = spatial.gather_rows(proj, dim=1, sum_grads=True, site="dcnv3")
        out = dcnv3_sampling(proj, offset, mask.contiguous(), self.kernel_size, self.stride,
                             self.pad, self.dilation, g, self.group_channels, self.offset_scale,
                             *band)
        return self.output_proj(out)


class DCNV3_YoLo(nn.Module):
    """1x1 Conv + DCNv3 on an NCHW tensor (JAX nn/dcn.py:DCNV3_YoLo; reference
    "common and yolo.py":2-13, which permutes to channels-last around DCNv3)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        self.conv = Conv(c1, c2, 1, act=act)
        self.dcnv3 = DCNv3(c2, k, s, (k - 1) // 2 * d, d, g)

    def forward(self, x):
        y = self.dcnv3(self.conv(x).permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2).contiguous()


class Bottleneck_DCNV3(nn.Module):
    """Bottleneck whose second conv is DCNV3_YoLo (JAX nn/dcn.py:Bottleneck_DCNV3)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = DCNV3_YoLo(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3_DCNV3(C3):
    """C3 with DCNv3 bottlenecks (JAX nn/dcn.py:C3_DCNV3; reference
    "common and yolo.py":26-38)."""

    def inner(self, c_, n, shortcut, g, act):
        return [Bottleneck_DCNV3(c_, c_, shortcut, g, e=1.0) for _ in range(n)]
