"""Local-window self-attention blocks of the `attention/` configs, NCHW (port
of yolo_dual_tpu/nn/attention.py; reference models/common.py:1509-1627).

As in JAX, the k x k windows are k² shifted slices of the padded map (torch's
unfold is not needed), and each window's softmax is over its k² positions, in
float32. Parameter names and the layouts of `rel_h` (k, 1, c2 / 2), `rel_w`
(1, k, c2 / 2), `emb_a`, `emb_b` (c2 / groups, k) and `emb_mix` (m, c2 / groups)
are JAX's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _windows(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, k·k, H', W') windows of the zero-padded map,
    window row-major (JAX `_windows`)."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return torch.stack([xp[:, :, i:i + oh * stride:stride, j:j + ow * stride:stride]
                        for i in range(k) for j in range(k)], 2)


def _attend(q: torch.Tensor, k_win: torch.Tensor, v_win: torch.Tensor) -> torch.Tensor:
    """Σ over the window of softmax_window(q · k) · v, channel by channel; q is
    cropped to the window grid, as JAX crops it."""
    oh, ow = k_win.shape[-2:]
    logits = q[:, :, None, :oh, :ow] * k_win
    attn = logits.float().softmax(2).to(logits.dtype)
    return (attn * v_win).sum(2)


class AttentionConv(nn.Module):
    """Window attention with relative position embeddings (JAX
    nn/attention.py:34): `rel_h` added to the keys' first c2 / 2 channels
    varies along the window's rows, `rel_w` on the second half along its
    columns. Config args [c2, k, s, p, groups]."""

    def __init__(self, c1, c2, k=3, s=1, p=1, groups=1, bias=False):
        super().__init__()
        assert c2 % groups == 0
        self.k, self.s, self.p = k, s, p
        self.query_conv = nn.Conv2d(c1, c2, 1, bias=bias)
        self.key_conv = nn.Conv2d(c1, c2, 1, bias=bias)
        self.value_conv = nn.Conv2d(c1, c2, 1, bias=bias)
        self.rel_h = nn.Parameter(torch.empty(k, 1, c2 // 2))
        self.rel_w = nn.Parameter(torch.empty(1, k, c2 // 2))

    def forward(self, x):
        k, s = self.k, self.s
        k_win = _windows(self.key_conv(x), k, s, self.p)
        rel = torch.cat([self.rel_h.expand(k, k, -1), self.rel_w.expand(k, k, -1)], -1)
        k_win = k_win + rel.reshape(k * k, -1).t()[None, :, :, None, None].to(k_win.dtype)
        q = self.query_conv(x)
        if s > 1:
            q = q[:, :, ::s, ::s]
        return _attend(q, k_win, _windows(self.value_conv(x), k, s, self.p))


class AttentionStem(nn.Module):
    """Stem attention (JAX nn/attention.py:79): `m` value branches mixed, per
    window position, by a softmax over the branches of emb_mix · emb_a (along
    the window's rows) + emb_mix · emb_b (along its columns)."""

    def __init__(self, c1, c2, k=3, s=1, p=0, groups=1, m=4, bias=False):
        super().__init__()
        cg = c2 // groups
        self.k, self.s, self.p, self.m = k, s, p, m
        self.query_conv = nn.Conv2d(c1, c2, 1, bias=bias)
        self.key_conv = nn.Conv2d(c1, c2, 1, bias=bias)
        for i in range(m):
            setattr(self, f"value_conv_{i}", nn.Conv2d(c1, c2, 1, bias=bias))
        self.emb_a = nn.Parameter(torch.empty(cg, k))
        self.emb_b = nn.Parameter(torch.empty(cg, k))
        self.emb_mix = nn.Parameter(torch.empty(m, cg))

    def forward(self, x):
        k, s, p = self.k, self.s, self.p
        emb = (self.emb_mix @ self.emb_a)[:, :, None] + (self.emb_mix @ self.emb_b)[:, None, :]
        emb = emb.reshape(self.m, k * k).softmax(0)
        v_win = None
        for i in range(self.m):
            vi = _windows(getattr(self, f"value_conv_{i}")(x), k, s, p) \
                * emb[i].to(x.dtype)[None, None, :, None, None]
            v_win = vi if v_win is None else v_win + vi
        return _attend(self.query_conv(x), _windows(self.key_conv(x), k, s, p), v_win)
