"""DCNv3 blocks (port of the DCNv3 half of yolo_dual_tpu/nn/dcn.py; reference
models/ops_dcnv3 modules/dcnv3.py and the YOLO glue "common and yolo.py").

`DCNv3` is channels-last, as in the JAX package and the reference; the port's
graph is NCHW, so `DCNV3_YoLo` permutes around it as the reference does.
Attribute names follow the JAX variable tree (`cv1`, `cv2.conv`,
`cv2.dcnv3.{input_proj,dw_conv,offset,mask,output_proj}`), so weights carried
by io/weights.py:state_dict_from_flax load with `strict=True`.

The sampling itself and its gradient, with the plain `dcnv3_coords`,
`dcnv3_core` and `dcnv3_core_bwd` they are held against, are in
kernels/dcn_sampling.py: the CUDA kernels on the card, the plain versions on
the CPU.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
from yolo_dual_tpu_torch.nn.common import C3, Conv


class DCNv3(nn.Module):
    """InternImage DCNv3 (JAX nn/dcn.py:DCNv3): input_proj; a depthwise
    Conv + BN + SiLU feeding the linear offset and mask heads; the mask
    softmaxed in float32 over the kk points of each group; deformable
    sampling; output_proj. (B, H, W, C) -> (B, Ho, Wo, C)."""

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
        out = dcnv3_sampling(proj, offset, mask.contiguous(), self.kernel_size, self.stride,
                             self.pad, self.dilation, g, self.group_channels, self.offset_scale)
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
