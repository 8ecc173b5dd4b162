"""Fused letterbox-resize + pad + normalize (port of
yolo_dual_tpu/kernels/preprocess.py).

`letterbox_normalize` launches the hand-written CUDA kernel csrc/letterbox.cu on
a CUDA tensor and runs the plain torch version, `letterbox_normalize_reference`,
on a CPU tensor. Output is NCHW float32 (B, 3, S, S) in [0, 1].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear half-pixel interpolation matrix."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        wx = src - x0
        for xx, ww in ((x0, 1 - wx), (x0 + 1, wx)):
            if 0 <= xx < n_in:
                m[i, xx] += ww
            else:
                m[i, np.clip(xx, 0, n_in - 1)] += ww  # edge clamp
    return m


def axis_taps(n_in: int, n_out: int):
    """Per-output-index bilinear taps along one axis: (taps (n_out, 2) int32,
    weights (n_out, 2) float32), the two nonzeros of each `_resize_matrix` row
    (a clamped tap repeats its index). Same float64 formula, so the kernel's
    tap choice carries no float32 rounding."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(src)
    w = src - x0
    x0 = x0.astype(np.int64)
    taps = np.stack([np.clip(x0, 0, n_in - 1), np.clip(x0 + 1, 0, n_in - 1)], 1).astype(np.int32)
    weights = np.stack([1 - w, w], 1).astype(np.float32)
    return taps, weights


@functools.lru_cache(maxsize=64)
def _device_taps(n_in: int, n_out: int, device: torch.device):
    taps, weights = axis_taps(n_in, n_out)
    return torch.from_numpy(taps).to(device), torch.from_numpy(weights).to(device)


def _content_box(h: int, w: int, s: int, scaleup: bool):
    """(ratio, nh, nw, top, left) of the resized frame on the (s, s) canvas."""
    r = min(s / h, s / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = int(round(h * r)), int(round(w * r))
    return r, nh, nw, (s - nh) // 2, (s - nw) // 2


def letterbox_geometry(h: int, w: int, out_size: int, scaleup: bool = True):
    """(ratio, (left, top)) the kernel applies, for host-side box bookkeeping."""
    r, _, _, top, left = _content_box(h, w, out_size, scaleup)
    return r, (left, top)


def _check_images(images: torch.Tensor):
    if images.dtype != torch.uint8:
        raise TypeError(f"letterbox_normalize expects uint8 frames, got {images.dtype}")
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"letterbox_normalize expects (B, H, W, 3), got {tuple(images.shape)}")


def letterbox_normalize_reference(images: torch.Tensor, out_size: int = 640,
                                  fill: float = 114.0, scaleup: bool = True) -> torch.Tensor:
    """Plain torch version: the `_resize_matrix` products, the pad and the /255.
    uint8 (B, H, W, 3) -> float32 (B, 3, S, S). Honours `scaleup` (the JAX numpy
    reference does not)."""
    _check_images(images)
    b, h, w, _ = images.shape
    s = out_size
    _, nh, nw, top, left = _content_box(h, w, s, scaleup)
    rm = torch.from_numpy(_resize_matrix(h, nh)).to(images.device)         # (nh, h)
    cm = torch.from_numpy(_resize_matrix(w, nw)).to(images.device)         # (nw, w)
    x = images.permute(0, 3, 1, 2).float()                                 # (b, 3, h, w)
    rows = torch.einsum("oh,bchw->bcow", rm, x)
    resized = torch.einsum("bcow,pw->bcop", rows, cm)
    out = torch.full((b, 3, s, s), float(np.float32(fill)), dtype=torch.float32,
                     device=images.device)
    out[:, :, top:top + nh, left:left + nw] = resized
    return out / 255.0


def letterbox_normalize(images: torch.Tensor, out_size: int = 640, fill: float = 114.0,
                        scaleup: bool = True) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 (B, 3, S, S) in [0, 1], aspect-preserving,
    centered, `fill`-padded (the reference letterbox semantics). scaleup=False
    pads small frames instead of upscaling them.

    On a CUDA tensor this launches csrc/letterbox.cu and counts the launch in
    `letterbox_normalize.launches`; on a CPU tensor it runs the plain version.
    """
    if images.device.type == "cpu":
        return letterbox_normalize_reference(images, out_size, fill, scaleup)
    if images.device.type != "cuda":
        raise ValueError(f"letterbox_normalize: unsupported device {images.device}")
    _check_images(images)
    if not images.is_contiguous():
        raise ValueError("letterbox_normalize expects a contiguous (B, H, W, 3) tensor")
    b, h, w, _ = images.shape
    s = out_size
    _, nh, nw, top, left = _content_box(h, w, s, scaleup)
    ytap, yw = _device_taps(h, nh, images.device)
    xtap, xw = _device_taps(w, nw, images.device)
    out = torch.empty((b, 3, s, s), dtype=torch.float32, device=images.device)
    lib = _library()
    with torch.cuda.device(images.device):
        rc = lib.letterbox_normalize_launch(
            images.data_ptr(), out.data_ptr(), b, h, w, s,
            ytap.data_ptr(), yw.data_ptr(), nh, top, xtap.data_ptr(), xw.data_ptr(), nw, left,
            float(fill), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"letterbox_normalize kernel launch failed: "
                           f"{lib.letterbox_error_string(rc).decode()}")
    letterbox_normalize.launches += 1
    return out


letterbox_normalize.launches = 0


def _library() -> ctypes.CDLL:
    from yolo_dual_tpu_torch.kernels.build import load_library
    lib = load_library("letterbox")
    if lib.letterbox_normalize_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.letterbox_normalize_launch.argtypes = [p, p, i, i, i, i, p, p, i, i, p, p, i, i,
                                                   ctypes.c_float, p]
        lib.letterbox_normalize_launch.restype = ctypes.c_int
        lib.letterbox_error_string.argtypes = [ctypes.c_int]
        lib.letterbox_error_string.restype = ctypes.c_char_p
    return lib
