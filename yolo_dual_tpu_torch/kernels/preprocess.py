"""Fused letterbox-resize + pad + normalize, and the semantic input path
around it (port of yolo_dual_tpu/kernels/preprocess.py).

`letterbox_normalize` launches the hand-written CUDA kernel csrc/letterbox.cu on
a CUDA tensor and runs the plain torch version, `letterbox_normalize_reference`,
on a CPU tensor. Output is NCHW float32 (B, 3, S, S) in [0, 1].
`semantic_preprocess` letterboxes frames through it at fill 128 and gathers
their dense masks onto the same canvas.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


ROWS, COLS = 4, 2  # csrc/letterbox.cu's blocks of 32 x ROWS threads, COLS output columns
# a thread: chosen from a grid measured on the card (kernels/bench_letterbox.py plans; PERF.md)


class LaunchParams(ctypes.Structure):
    """One geometry's launch: csrc/letterbox.cu's LetterboxLaunch, built once
    and passed by pointer. `both`: read both taps of every row and column
    without a branch, for a geometry with no tap of weight 0."""
    _fields_ = [("tables", ctypes.c_void_p),
                *((name, ctypes.c_int) for name in (
                    "H", "W", "S", "nh", "nw", "top", "left", "both", "rows", "cols")),
                ("fill", ctypes.c_float)]


class LaunchRecord(NamedTuple):
    tables: torch.Tensor  # int32 (nh + nw, 4) on the frames' device: row taps, column taps
    geometry: tuple       # (h, w, s, nh, nw, top, left)
    fill: float           # fill / 255 in float32, the plain version's pad value
    params: LaunchParams  # holds tables.data_ptr(): the record keeps the tables alive


def letterbox_tables(h: int, w: int, s: int, scaleup: bool):
    """The kernel's tap tables: (rows (nh, 4) int32, columns (nw, 4) int32). A
    row is (tap 0, tap 1, weight 0, weight 1), the weights as float32 bits; a
    column the same with its taps as byte offsets in a frame row. The taps and
    weights are `axis_taps`'s, but a second tap of weight 0 repeats the first:
    the kernel does not read it."""
    _, nh, nw, _, _ = _content_box(h, w, s, scaleup)
    if nh < 1 or nw < 1:
        raise ValueError(f"letterbox_normalize: a {h}x{w} frame leaves no content on a "
                         f"{s}x{s} canvas")
    out = []
    for n_in, n_out in ((h, nh), (w, nw)):
        taps, weights = axis_taps(n_in, n_out)
        taps = np.where(weights > 0, taps, taps[:, :1])
        out.append(np.concatenate([taps, weights.view(np.int32)], 1))
    rows, cols = out
    cols[:, :2] *= 3
    return rows, cols


def letterbox_launch_record(h: int, w: int, s: int, fill: float, scaleup: bool,
                            device) -> LaunchRecord:
    """The tap tables of one geometry, on `device`, and its launch: the
    "both taps" variant where no tap has weight 0."""
    _, nh, nw, top, left = _content_box(h, w, s, scaleup)
    rows, cols = letterbox_tables(h, w, s, scaleup)
    tables = torch.from_numpy(np.concatenate([rows, cols])).to(device)
    both = bool((rows[:, 3] != 0).all() and (cols[:, 3] != 0).all())
    fill = float(np.float32(fill) / np.float32(255.0))
    return LaunchRecord(tables, (h, w, s, nh, nw, top, left), fill,
                        LaunchParams(tables.data_ptr(), h, w, s, nh, nw, top, left, both, ROWS,
                                     COLS, fill))


# (h, w, s, fill, scaleup, device index) -> LaunchRecord. Never evicted: a CUDA graph
# captured with a record's launch reads its tables at every replay. A record is a few KB.
_RECORDS: dict = {}


def launch_record(h: int, w: int, s: int, fill: float, scaleup: bool,
                  device: torch.device) -> LaunchRecord:
    """The cached launch record of a geometry, built at its first call."""
    key = (h, w, s, fill, scaleup, device.index)
    rec = _RECORDS.get(key)
    if rec is None:
        rec = _RECORDS[key] = letterbox_launch_record(h, w, s, fill, scaleup, device)
    return rec


def letterbox_normalize(images: torch.Tensor, out_size: int = 640, fill: float = 114.0,
                        scaleup: bool = True) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 (B, 3, S, S) in [0, 1], aspect-preserving,
    centered, `fill`-padded (the reference letterbox semantics). scaleup=False
    pads small frames instead of upscaling them.

    On a CUDA tensor this launches csrc/letterbox.cu and counts the launch in
    `letterbox_normalize.launches`; on a CPU tensor it runs the plain version.
    After the first call of a geometry a call makes no host synchronisation
    and no host-to-device copy, so it can be captured in a CUDA graph.
    """
    if images.device.type == "cpu":
        return letterbox_normalize_reference(images, out_size, fill, scaleup)
    if images.device.type != "cuda":
        raise ValueError(f"letterbox_normalize: unsupported device {images.device}")
    _check_images(images)
    if not images.is_contiguous():
        raise ValueError("letterbox_normalize expects a contiguous (B, H, W, 3) tensor")
    b, h, w, _ = images.shape
    dev = images.device
    rec = _RECORDS.get((h, w, out_size, fill, scaleup, dev.index)) or \
        launch_record(h, w, out_size, fill, scaleup, dev)
    out = torch.empty((b, 3, out_size, out_size), dtype=torch.float32, device=dev)
    if b:
        _launch(images, out, rec.params)
        letterbox_normalize.launches += 1
    return out


letterbox_normalize.launches = 0


def _launch(images: torch.Tensor, out: torch.Tensor, params: LaunchParams):
    """Launch csrc/letterbox.cu on the current stream of the frames' device."""
    launch, error_string = _BOUND or _bind()
    args = (images.data_ptr(), out.data_ptr(), images.shape[0], params)
    if images.device.index == torch.cuda.current_device():
        rc = launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(images.device):
            rc = launch(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"letterbox_normalize kernel launch failed: "
                           f"{error_string(rc).decode()}")


_BOUND: list = []  # (launch, error string), bound once


def _bind():
    """Build and load csrc/letterbox.cu at first use and bind its two
    functions; later calls find them in `_BOUND` without the build's locks."""
    from yolo_dual_tpu_torch.kernels.build import load_library
    lib = load_library("letterbox")
    launch, error_string = lib.letterbox_normalize_launch, lib.letterbox_error_string
    p = ctypes.c_void_p
    launch.argtypes = [p, p, ctypes.c_int, ctypes.POINTER(LaunchParams), p]
    launch.restype = ctypes.c_int
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    _BOUND[:] = launch, error_string
    return _BOUND


def _nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source indices of the device route's nearest mask resize (JAX
    kernels/preprocess.py:135): floor((i + 0.5) * n_in / n_out). Not
    cv2.INTER_NEAREST's floor(i * n_in / n_out), which the host route uses
    (data/json_dataset.py:resize_nearest_u8), although JAX's docstring says so."""
    return np.clip(np.floor((np.arange(n_out) + 0.5) * (n_in / n_out)),
                   0, n_in - 1).astype(np.int64)


_MASK_INDICES: dict = {}


def mask_indices(h: int, w: int, nh: int, nw: int, device: torch.device):
    """The (rows, cols) int64 gather indices of `_nearest_indices` for an
    (h, w) mask fitted to (nh, nw), on `device`; made once a geometry and
    device, as K1's launch records are, so a batch copies only its frames
    and masks to the card."""
    key = (h, w, nh, nw, device)
    idx = _MASK_INDICES.get(key)
    if idx is None:
        idx = _MASK_INDICES[key] = (torch.from_numpy(_nearest_indices(h, nh)).to(device),
                                    torch.from_numpy(_nearest_indices(w, nw)).to(device))
    return idx


def _semantic(letterbox, images, masks, out_size, fill, flip, bright, contr):
    """The semantic input path with `letterbox` as its image resize (JAX
    kernels/preprocess.py:142-185): the frames letterboxed at `fill`
    (scaleup), the masks nearest-gathered onto a zero canvas, then the
    per-sample flip, brightness and contrast of the padded canvas."""
    if masks.ndim != 3 or tuple(masks.shape) != tuple(images.shape[:3]):
        raise ValueError(f"semantic_preprocess: masks {tuple(masks.shape)} do not match frames "
                         f"{tuple(images.shape)}")
    imgs = letterbox(images, out_size, fill=fill, scaleup=True)
    b, h, w = masks.shape
    _, nh, nw, top, left = _content_box(h, w, out_size, True)
    dev = images.device
    ry, rx = mask_indices(h, w, nh, nw, dev)
    m = masks.to(dev).index_select(1, ry).index_select(2, rx).to(torch.int32)
    canvas = torch.zeros((b, out_size, out_size), dtype=torch.int32, device=dev)
    canvas[:, top:top + nh, left:left + nw] = m
    if flip is not None:
        f = torch.as_tensor(flip, device=dev).bool()
        imgs = torch.where(f[:, None, None, None], imgs.flip(-1), imgs)
        canvas = torch.where(f[:, None, None], canvas.flip(-1), canvas)
    if bright is not None:
        imgs = imgs * torch.as_tensor(bright, dtype=torch.float32, device=dev)[:, None, None, None]
    if contr is not None:
        c = torch.as_tensor(contr, dtype=torch.float32, device=dev)[:, None, None, None]
        mean = imgs.mean(dim=(1, 2, 3), keepdim=True)
        imgs = (imgs - mean) * c + mean
    if bright is not None or contr is not None:
        imgs = imgs.clamp(0.0, 1.0)
    return imgs, canvas


def semantic_preprocess(images: torch.Tensor, masks: torch.Tensor, out_size: int = 640,
                        fill: float = 128.0, flip=None, bright=None, contr=None):
    """The device route's semantic input path (JAX kernels/preprocess.py:142):
    uint8 frames (b, H, W, 3) at their native size and their integer class
    masks (b, H, W) -> (images float32 (b, 3, S, S) in [0, 1], masks int32
    (b, S, S)). The frames go through `letterbox_normalize` at `fill` with
    scaleup (on a CUDA tensor K1, csrc/letterbox.cu, one launch a call; it
    raises rather than fall back); the masks are nearest-gathered
    (`_nearest_indices`) and padded with class 0. flip / bright / contr:
    optional per-sample (b,) bool / float32 / float32 augmentations, applied
    to the padded canvas, as JAX applies them."""
    return _semantic(letterbox_normalize, images, masks, out_size, fill, flip, bright, contr)


def semantic_preprocess_reference(images: torch.Tensor, masks: torch.Tensor, out_size: int = 640,
                                  fill: float = 128.0, flip=None, bright=None, contr=None):
    """Plain version of `semantic_preprocess` on any device: K1's plain version
    (`letterbox_normalize_reference`) and the same gathers."""
    return _semantic(letterbox_normalize_reference, images, masks, out_size, fill, flip,
                     bright, contr)
