#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (yolo_dual_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --device-times [ROOT]

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
without a CUDA device it exits non-zero and prints no result. Phases, each of
which raises on failure:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/letterbox.cu, csrc/dcnv3.cu and csrc/dcnv3_bwd.cu from
   this checkout with nvcc, one process each, started together;
3. kernels: each kernel against its plain torch version at the shapes its
   main paths give it, with its time, the plain version's, one library call's
   (timed only) and the least time the card could take:
   - letterbox (max abs error <= 1e-5; library: F.interpolate + F.pad + /255);
   - DCNv3 sampling (K2) at the three shapes of yolov5s-seg-dcnv3 at 640 px,
     batch 1, 16 and 32, with seeded offsets of a few px that reach past the
     border (max abs error <= 1e-5; library: the reference's F.grid_sample
     formulation);
   - DCNv3 backward (K3) at the same shapes at batch 16, the training path's
     (dx, doffset, dmask each within 1e-5 of its largest magnitude; library:
     autograd's backward of the grid_sample formulation);
   for K2 and K3 also each shape's launch plan and the share of samples with
   a corner outside their block's shared-memory window;
4. slice, for each model: yolov5s-seg and yolov5s-seg-dcnv3 (nc=80, 640 px,
   full width and depth, seeded random weights with the bias prior; the DCNv3
   offset and mask heads drawn from the seeded generator so offsets span ~2
   px; BatchNorm statistics calibrated on three seeded frames; conv+BN fused)
   predict 16 in-memory frames of 1080p, 720p and 480p on cuda; every frame
   keeps detections, and the launch counts, set to 0 just before and read
   just after, are 16 letterbox launches and 6 DCNv3 launches per frame on the
   DCNv3 model (0 on the other);
5. card against CPU, for each model: two frames through the same model on the
   GPU and on the CPU, TF32 off: raw level maps and protos agree to rtol 1e-3,
   detections by the matching rule of tests/test_torch_port_predict.py; for
   yolov5s-seg-dcnv3 both float32 runs are also matched against a float64 CPU
   run and the shares printed;
6. timing, for each model: the streaming predictor's per-frame pre/infer/post
   ms, and the batched forward + nms_from_raw at bs 32, 640 px in img/s;
7. training (slice 3): yolov5s-seg-dcnv3 as in 4 but unfused, SGD with
   hyp.scratch-low, bs 16, 640 px, accumulate 4, EMA, takes 8 micro-steps of
   seeded synthetic batches (uint8 images, 1-8 boxes an image, 160-px
   overlap-indexed masks with each instance inside its box) through
   Trainer.train_step; every loss item is finite, the counts set to 0 just
   before read 48 K2 and 48 K3 launches, the parameters move at micro-steps 4
   and 8 only, the EMA counts 2 updates; the model's offsets on the first
   batch and the share of their samples outside the kernels' windows; then 8
   more micro-steps are timed, split as forward+loss / backward /
   optimizer+EMA (CUDA events), in img/s, and (after phase 9)
   torch.profiler records one accumulation cycle (device busy share, the
   kernels that take most);
8. card against CPU, training: one train_step of the same model at bs 2,
   256 px, TF32 off, past warmup, from the same weights and batch on the GPU
   and on the CPU, and on the CPU in float64: loss items agree to 1e-4, and
   every gradient and parameter update of the card stands no further from the
   float64 step than the CPU's float32 does (see train_card_vs_cpu);
9. device times: each K2 and K3 shape's own device time per launch from
   torch.profiler (at batch 1 the CUDA events of phase 3 measure the host's
   wrapper as well), after every timed path, as a profiler session can slow
   the host's later launches; then K2's and K3's device times on the inputs
   of the trained model's six DCNv3 calls (bs 16, its offsets after phase 7)
   under window margins of 1 and 2 px, each beside its window-escape share;
10. a JSON line of every kernel with its launches on the main paths, then the
   JSON result line.

`--device-times ROOT` runs phase 1 and phase 9's device times at every DCNv3
path shape only, with the package of the checkout at ROOT (default: this one),
for instance the parent commit unpacked with `git archive`: the same
measurement of two versions in one call. It prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 rate (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
CONF_LOW = 1e-6  # random weights give confidences ~1e-5: keep NMS and masks busy
MAIN_SHAPES = {"1080p": (1080, 1920), "720p": (720, 1280), "480p": (480, 640)}
N_FRAMES = 16
MODELS = ("yolov5s-seg.json", "yolov5s-seg-dcnv3.json")
# DCNv3 sampling calls of one yolov5s-seg-dcnv3 forward at 640 px: (H, W, C) -> calls
DCN_PATH_SHAPES = {(80, 80, 64): 2, (40, 40, 128): 3, (20, 20, 256): 1}
DCN_OFFSET_BIAS_PX = 1.0  # the smoke model's DCNv3 offset heads: biases N(0, 1 px^2) ...
DCN_OFFSET_GAIN = 0.2  # ... and weights N(0, gain^2 / fan_in); see draw_dcnv3_heads
TRAIN_BS, TRAIN_IMGSZ, TRAIN_MICRO_STEPS, TRAIN_MAX_BOXES = 16, 640, 8, 8
ACCUMULATE = max(round(64 / TRAIN_BS), 1)  # nominal batch 64 (segment/train.py --nbs)
EPOCHS, STEPS_PER_EPOCH = 100, 7393  # the CLI's default epochs; COCO train2017 at bs 16


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of `fn`, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_kernel_ms(fn, kernel: str, iters: int):
    """Mean device ms per launch of the CUDA kernels whose name holds `kernel`
    over `iters` calls of `fn`, each of which launches one, from
    torch.profiler's kernel records: the kernel's own time, without the host
    wrapper that CUDA events around the call also count at batch 1. Late in a
    long process the profiler can drop records: a session that did not record
    `iters` launches is run again, up to three times, else "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        if sum(e.count for e in events) == iters:
            return sum(e.self_device_time_total for e in events) / iters / 1e3
    return "not measured"


def window_escapes(offset, h: int, w: int, group_channels: int, backward: bool, kernel=3,
                   stride=1, pad=1, dilation=1, group=1, offset_scale=1.0) -> dict:
    """The DCNv3 launch plan of one call and the share of its samples with a
    corner outside their block's window: those read (and in the backward
    added) in device memory instead of shared memory."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_plan, dcnv3_window_escapes
    plan = dcnv3_plan(offset.shape[0], *offset.shape[1:3], group, group_channels, kernel,
                      stride, pad, dilation, offset_scale, backward)
    return {"plan": "tile {}x{} window {}x{} chunk {} x{}".format(
                plan.th, plan.tw, plan.wh, plan.ww, plan.cc, plan.cpb),
            "escapes": dcnv3_window_escapes(offset, h, w, kernel, stride, pad, dilation, group,
                                            offset_scale, plan)}


def letterbox_bytes(b: int, h: int, w: int, s: int, scaleup: bool) -> int:
    """Least bytes the letterbox of b (h, w, 3) uint8 frames onto an (s, s)
    canvas must move: the float32 canvas written once, plus the 32-byte
    sectors of each frame that hold a tap of nonzero weight, read once. A
    downscale by 3 (1080p -> 640) needs only every third row and column; its
    second tap has weight 0. Frames are b back-to-back copies of one layout,
    so one frame's sectors are counted and multiplied by b."""
    from yolo_dual_tpu_torch.kernels.preprocess import _content_box, axis_taps
    _, nh, nw, _, _ = _content_box(h, w, s, scaleup)

    def needed(n_in, n_out):
        taps, weights = axis_taps(n_in, n_out)
        return np.unique(taps[weights > 0]).astype(np.int64)
    rows, cols = needed(h, nh), needed(w, nw)
    col_bytes = (3 * cols[:, None] + np.arange(3)).ravel()
    sectors = np.unique((rows[:, None] * (w * 3) + col_bytes[None, :]) // 32)
    return b * len(sectors) * 32 + b * 3 * s * s * 4


def library_letterbox(x: torch.Tensor, s: int, fill: float, scaleup: bool) -> torch.Tensor:
    """One library pipeline for the same function: bilinear F.interpolate,
    F.pad and /255. Timed as a yardstick only; the port never calls it."""
    from yolo_dual_tpu_torch.kernels.preprocess import _content_box
    _, nh, nw, top, left = _content_box(x.shape[1], x.shape[2], s, scaleup)
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(nh, nw), mode="bilinear",
                      align_corners=False)
    return F.pad(y, (left, s - nw - left, top, s - nh - top), value=fill) / 255.0


def letterbox_phase():
    from yolo_dual_tpu_torch.kernels.preprocess import (
        letterbox_normalize, letterbox_normalize_reference)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full f32
    cases = [  # name, (B, H, W), out_size, fill, scaleup
        ("1080p", (1, 1080, 1920), 640, 114.0, True),
        ("720p", (1, 720, 1280), 640, 114.0, True),
        ("480p", (1, 480, 640), 640, 114.0, True),
        ("720p_bs32", (32, 720, 1280), 640, 114.0, True),
        ("240p_upscale", (1, 240, 320), 640, 114.0, True),
        ("240p_no_scaleup", (1, 240, 320), 640, 114.0, False),
        ("720p_fill128", (1, 720, 1280), 640, 128.0, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (b, h, w), s, fill, scaleup in cases:
        x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        out = letterbox_normalize(x, s, fill=fill, scaleup=scaleup)
        ref = letterbox_normalize_reference(x, s, fill=fill, scaleup=scaleup)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (b, 3, s, s), (out.shape, ref.shape)
        err = (out - ref).abs().max().item()
        lib_err = (library_letterbox(x, s, fill, scaleup) - ref).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"letterbox {name}: max abs error {err} > 1e-5")
        # cycle inputs whose total exceeds the 50 MB L2, as a stream of new frames would
        nbytes = letterbox_bytes(b, h, w, s, scaleup)
        xs =[x] + [torch.randint(0, 256, x.shape, dtype=torch.uint8, device="cuda", generator=gen)
                    for _ in range(max(0, -(-64 * 2**20 // (b * h * w * 3)) - 1))]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(xs)
            return xs[it["i"]]
        iters = 20 if b > 1 else 200
        r = dict(
            shape=[b, h, w, 3], out_size=s, fill=fill, scaleup=scaleup, max_abs_err=err,
            library_max_abs_diff=lib_err,
            ms=cuda_ms(lambda: letterbox_normalize(nxt(), s, fill=fill, scaleup=scaleup), iters),
            plain_ms=cuda_ms(lambda: letterbox_normalize_reference(nxt(), s, fill=fill,
                                                                   scaleup=scaleup), iters),
            library_ms=cuda_ms(lambda: library_letterbox(nxt(), s, fill, scaleup), iters),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
        results[name] = r
        print(f"kernel letterbox_normalize {name} {r['shape']}->{s} fill={fill} scaleup={scaleup}: "
              f"max_abs_err={err:.3g} kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} (library max diff {lib_err:.3g}) "
              f"bound_ms={r['bound_ms']:.5f} ({nbytes} bytes)", flush=True)
        del xs, x, out, ref
    return results


def dcnv3_bytes(b: int, h: int, w: int, c: int, kk: int) -> int:
    """Least bytes one DCNv3 sampling call must move (stride 1, one group): x,
    offset and mask read once, the output written once, all float32."""
    return 4 * (b * h * w * c + b * h * w * kk * 3 + b * h * w * c)


def dcnv3_flops(b: int, h: int, w: int, c: int, kk: int) -> int:
    """Float32 operations of the sampling sum: per output value and sample
    point, the two-level bilinear blend (3 x 3) and the masked accumulate (2)."""
    return 11 * b * h * w * c * kk


def dcnv3_inputs(gen, b, h, w, c, k=3):
    """Seeded channels-last inputs: offsets N(0, 1.5 px), which carry samples
    past the border, and a mask softmaxed over the kk points."""
    kk = k * k
    x = torch.randn(b, h, w, c, device="cuda", generator=gen)
    offset = torch.randn(b, h, w, kk * 2, device="cuda", generator=gen) * 1.5
    mask = torch.randn(b, h, w, kk, device="cuda", generator=gen).softmax(-1)
    return x, offset, mask


def dcnv3_phase():
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (
        dcnv3_coords, dcnv3_core, dcnv3_core_grid_sample, dcnv3_sampling)
    gen = torch.Generator(device="cuda").manual_seed(2)
    args = (3, 1, 1, 1, 1)  # kernel, stride, pad, dilation, group
    results = {}
    for b in (1, TRAIN_BS, 32):
        for (h, w, c) in DCN_PATH_SHAPES:
            name = f"{b}x{h}x{w}x{c}"
            x, offset, mask = dcnv3_inputs(gen, b, h, w, c)
            with torch.no_grad():
                out = dcnv3_sampling(x, offset, mask, *args, c, 1.0)
                ref = dcnv3_core(x, offset, mask, *args, c, 1.0)
                lib = dcnv3_core_grid_sample(x, offset, mask, *args, c, 1.0)
                sx, sy = dcnv3_coords(offset, 3, 1, 1, 1, 1)
            torch.cuda.synchronize()
            assert out.shape == ref.shape == (b, h, w, c), (out.shape, ref.shape)
            err = (out - ref).abs().max().item()
            lib_err = (lib - ref).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"dcnv3_sampling {name}: max abs error {err} > 1e-5")
            # share of samples with a corner outside the unpadded image (padded coords, pad 1)
            x0, y0 = sx.floor(), sy.floor()
            outside = ((x0 < 1) | (x0 + 1 > w) | (y0 < 1) | (y0 + 1 > h)).float().mean().item()
            if not outside > 0:
                raise AssertionError(f"dcnv3_sampling {name}: no sample reaches the border")
            nbytes = dcnv3_bytes(b, h, w, c, 9)
            flops = dcnv3_flops(b, h, w, c, 9)
            sets = [(x, offset, mask)] + [dcnv3_inputs(gen, b, h, w, c)
                                          for _ in range(max(0, -(-64 * 2**20 // nbytes) - 1))]
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(sets)
                return sets[it["i"]]
            iters = 20 if b > 1 else 200
            with torch.no_grad():
                r = dict(
                    shape=[b, h, w, c], max_abs_err=err, library_max_abs_diff=lib_err,
                    outside_share=outside,
                    ms=cuda_ms(lambda: dcnv3_sampling(*nxt(), *args, c, 1.0), iters),
                    plain_ms=cuda_ms(lambda: dcnv3_core(*nxt(), *args, c, 1.0), max(iters // 10, 5)),
                    library_ms=cuda_ms(lambda: dcnv3_core_grid_sample(*nxt(), *args, c, 1.0), iters),
                    bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops_ms=flops / FP32_FLOP_PER_S * 1e3,
                    bytes=nbytes, flops=flops)
            r["bound_ms"] = max(r["bytes_ms"], r["flops_ms"])
            r.update(window_escapes(offset, h, w, c, backward=False))
            results[name] = r
            print(f"kernel dcnv3_sampling {name} k3 s1 p1 d1 g1: max_abs_err={err:.3g} "
                  f"kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                  f"library_ms={r['library_ms']:.5f} (library max diff {lib_err:.3g}) "
                  f"bound_ms={r['bound_ms']:.5f} ({nbytes} bytes, {flops} flop), "
                  f"samples with a corner outside the image {outside:.4f}, "
                  f"outside their window {r['escapes']:.4f} ({r['plan']})", flush=True)
            del sets, x, offset, mask, out, ref, lib, sx, sy
    return results



def dcnv3_bwd_bytes(b: int, h: int, w: int, c: int, kk: int) -> int:
    """Least bytes one DCNv3 backward call must move (stride 1, one group): x,
    offset, mask and the output gradient read once, dx, doffset and dmask
    written once, all float32."""
    return 4 * (3 * b * h * w * c + 2 * b * h * w * kk * 3)


def dcnv3_bwd_flops(b: int, h: int, w: int, c: int, kk: int) -> int:
    """Least float32 operations of the backward per output value and sample
    point, an FMA counted as 2, with the mask folded into the four corner
    weights once per point: the row differences a = v1 − v0 and b = v3 − v2
    (2); top = v0 + wx·a and bot = v2 + wx·b (4); d = bot − top (1), which is
    d(sample)/dsy; the sample top + wy·d (2) and its product into dmask (2);
    d(sample)/dsx = a + wy·(b − a) (3) and the two products into doffset (4);
    the four weighted adds into dx (8). 26 in all."""
    return 26 * b * h * w * c * kk


def dcnv3_bwd_phase():
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (
        dcnv3_core_bwd, dcnv3_core_grid_sample, dcnv3_sampling_backward)
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = (3, 1, 1, 1, 1)  # kernel, stride, pad, dilation, group
    results = {}
    for (h, w, c) in DCN_PATH_SHAPES:
        b = TRAIN_BS
        name = f"{b}x{h}x{w}x{c}"

        def inputs():
            x, offset, mask = dcnv3_inputs(gen, b, h, w, c)
            return x, offset, mask, torch.randn(b, h, w, c, device="cuda", generator=gen)
        sets = [inputs()]
        got = dcnv3_sampling_backward(*sets[0], *args, c, 1.0)
        want = dcnv3_core_bwd(*sets[0], *args, c, 1.0)
        torch.cuda.synchronize()
        errs = {k: (a - r).abs().max().item() for k, a, r in zip(("dx", "doffset", "dmask"), got, want)}
        mags = {k: r.abs().max().item() for k, r in zip(("dx", "doffset", "dmask"), want)}
        for k in errs:
            if not errs[k] <= 1e-5 * max(1.0, mags[k]):
                raise AssertionError(f"dcnv3_sampling_backward {name} {k}: max abs error "
                                     f"{errs[k]} > 1e-5 x {mags[k]}")
        del got, want
        nbytes, flops = dcnv3_bwd_bytes(b, h, w, c, 9), dcnv3_bwd_flops(b, h, w, c, 9)
        sets += [inputs() for _ in range(max(0, -(-64 * 2**20 // nbytes) - 1))]
        # the library yardstick: autograd's backward of the grid_sample formulation
        graphs = []
        for x, offset, mask, g in sets:
            leaves = [t.detach().requires_grad_() for t in (x, offset, mask)]
            graphs.append((dcnv3_core_grid_sample(*leaves, *args, c, 1.0), leaves, g))
        it = {"i": 0}

        def nxt(seq):
            it["i"] = (it["i"] + 1) % len(seq)
            return seq[it["i"]]

        def library():
            out, leaves, g = nxt(graphs)
            return torch.autograd.grad(out, leaves, g, retain_graph=True)
        r = dict(
            shape=[b, h, w, c], max_abs_err=max(errs.values()), errs=errs, magnitudes=mags,
            ms=cuda_ms(lambda: dcnv3_sampling_backward(*nxt(sets), *args, c, 1.0), 20),
            plain_ms=cuda_ms(lambda: dcnv3_core_bwd(*nxt(sets), *args, c, 1.0), 5),
            library_ms=cuda_ms(library, 10),
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops_ms=flops / FP32_FLOP_PER_S * 1e3,
            bytes=nbytes, flops=flops)
        r["bound_ms"] = max(r["bytes_ms"], r["flops_ms"])
        r.update(window_escapes(sets[0][1], h, w, c, backward=True))
        results[name] = r
        print(f"kernel dcnv3_sampling_backward {name} k3 s1 p1 d1 g1: max abs error {errs} "
              f"(largest magnitudes {mags}) kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({nbytes} bytes, {flops} flop), samples outside their window "
              f"{r['escapes']:.4f} ({r['plan']})", flush=True)
        del sets, graphs
    torch.cuda.empty_cache()
    return results

def device_phase(dres: dict, bres: dict):
    """Phase 9, after every timed path (a profiler session can slow the host's
    later launches): each K2 and K3 shape's own device time per launch from
    torch.profiler, on fresh seeded inputs, into its result as `device_ms`. At
    batch 1 the CUDA events of phase 3 measure the host's wrapper as well.
    `dres` and `bres` map names to results that need only a `shape` [b, h, w,
    c], and the phase calls nothing but the public wrappers, so it times
    another checkout's kernels alike when that checkout's package is the one
    imported."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    gen = torch.Generator(device="cuda").manual_seed(9)
    args = (3, 1, 1, 1, 1)
    for res, kernel in ((dres, "dcnv3_sampling_kernel"), (bres, "dcnv3_backward_kernel")):
        for name, r in res.items():
            b, h, w, c = r["shape"]
            x, offset, mask = dcnv3_inputs(gen, b, h, w, c)
            if res is bres:
                gout = torch.randn(b, h, w, c, device="cuda", generator=gen)
                fn = lambda: dcnv3_sampling_backward(x, offset, mask, gout, *args, c, 1.0)  # noqa: E731
            else:
                def fn():
                    with torch.no_grad():
                        return dcnv3_sampling(x, offset, mask, *args, c, 1.0)
            r["device_ms"] = profiled_kernel_ms(fn, kernel, 200 if b == 1 else 20)
            print(f"device {kernel} {name}: {r['device_ms']} ms a launch", flush=True)
    torch.cuda.empty_cache()


def trained_inputs_phase(calls):
    """Phase 9, second part: K2's and K3's own device times (torch.profiler)
    on the inputs of the trained model's DCNv3 calls (bs 16, the offsets after
    the training micro-steps; a seeded output gradient), under the launch plan
    with a window margin of 1 px (the kernels' own) and of 2 px, each beside
    its share of samples outside the window. Each plan's result is first held against the plain
    version (1e-5 of each output's largest magnitude, as the model's
    activations exceed 1). Inputs are cycled in copies past the 50 MB L2."""
    import itertools
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (
        _launch, dcnv3_core, dcnv3_core_bwd, dcnv3_plan, dcnv3_window_escapes)
    gen = torch.Generator(device="cuda").manual_seed(10)
    for i, (x, offset, mask, cfg) in enumerate(calls):
        b, h, w, c = x.shape
        ho, wo = offset.shape[1:3]
        gout = torch.randn(b, ho, wo, c, device="cuda", generator=gen)
        ins = (x, offset, mask, gout)
        nbytes = sum(t.numel() * t.element_size() for t in ins)
        sets = [ins] + [tuple(t.clone() for t in ins) for _ in range(-(-64 * 2**20 // nbytes) - 1)]
        row = {"layer": i, "shape": [b, h, w, c], "offset_std_px": offset.std().item(),
               "offset_max_abs_px": offset.abs().max().item()}
        for backward in (False, True):
            want = (dcnv3_core_bwd(*ins, *cfg) if backward
                    else (dcnv3_core(x, offset, mask, *cfg),))
            for margin in (1, 2):
                plan = dcnv3_plan(b, ho, wo, cfg[4], cfg[5], *cfg[:4], cfg[6], backward, margin)
                it = itertools.cycle(sets)

                def run():
                    xs, off, m, g = next(it)
                    if backward:
                        outs = (torch.zeros_like(xs), torch.empty_like(off), torch.empty_like(m))
                        _launch("dcnv3_backward_launch", (xs, off, m, g, *outs), xs, off, *cfg,
                                plan=plan)
                    else:
                        outs = (torch.empty(b, ho, wo, c, device="cuda"),)
                        _launch("dcnv3_sampling_launch", (xs, off, m, *outs), xs, off, *cfg,
                                plan=plan)
                    return outs
                got = run()
                torch.cuda.synchronize()
                err = max((a - r).abs().max().item() / max(1.0, r.abs().max().item())
                          for a, r in zip(got, want))
                key = f"{'K3' if backward else 'K2'}_margin{margin}"
                if not err <= 1e-5:
                    raise AssertionError(f"trained inputs, layer {i} {key}: error {err} > 1e-5")
                row[key] = {
                    "plan": f"tile {plan.th}x{plan.tw} window {plan.wh}x{plan.ww} chunk {plan.cc}",
                    "device_ms": profiled_kernel_ms(
                        run, "dcnv3_backward_kernel" if backward else "dcnv3_sampling_kernel", 20),
                    "escapes": dcnv3_window_escapes(offset, h, w, *cfg[:5], cfg[6], plan),
                    "err": err}
            del want
        print("trained inputs " + json.dumps(row), flush=True)
        del sets
    torch.cuda.empty_cache()


def make_frames(n: int, seed: int = 0):
    """n seeded uint8 RGB frames cycling 1080p, 720p, 480p: smooth structure
    plus noise, made on the host as a camera or decoder would deliver them."""
    rng = np.random.default_rng(seed)
    frames = []
    sizes = list(MAIN_SHAPES.values())
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 100 * np.sin(xx / rng.uniform(20, 80) + rng.uniform(0, 6)) \
            * np.cos(yy / rng.uniform(20, 80))
        noise = rng.integers(-20, 21, (h, w, 3), dtype=np.int16)
        frames.append(np.clip(base[..., None] + noise, 0, 255).astype(np.uint8))
    return frames


def h2d_ms(frames) -> float:
    """Mean host-clock ms per frame of the predictor's pre stage without the
    letterbox: the pageable copy of the uint8 frame to the card, synchronized
    before and after as the stage's Profile timer is."""
    total = 0.0
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(f).to("cuda")[None].contiguous()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / len(frames) * 1e3


def calibrate_bn(model, frames):
    """Set every BatchNorm's running statistics to those of `frames` (a
    seeded calibration batch). With identity statistics a random network's
    activations shrink layer by layer until every score ties with every other;
    calibrated, the scores spread as a trained network's do, so NMS and the
    card-against-CPU comparison have real work."""
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.nn.common import BN_MOMENTUM
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch gives its own statistics
    x = torch.cat([letterbox_normalize(torch.from_numpy(f)[None].cuda(), 640) for f in frames])
    with torch.no_grad():
        model.train()(x)
    for bn in bns:
        bn.momentum = BN_MOMENTUM
    return model.eval()


def draw_dcnv3_heads(model, generator):
    """Replace the zero-initialized DCNv3 offset and mask heads with seeded
    weights, so samples leave the grid points and the bilinear weights are not
    trivial: offset biases N(0, (DCN_OFFSET_BIAS_PX px)^2), which set a fixed
    fractional shift per kernel point, plus offset weights N(0, gain^2 /
    fan_in) for a per-pixel part; mask weights N(0, 1 / fan_in). Offsets that
    follow the features more steeply make this random network chaotic: float32
    rounding then grows into different detections even between the CPU in
    float32 and in float64."""
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCNv3):
                for head, gain in ((m.offset, DCN_OFFSET_GAIN), (m.mask, 1.0)):
                    w = torch.randn(head.weight.shape, generator=generator)
                    head.weight.copy_(w * gain / math.sqrt(head.weight.shape[1]))
                m.offset.bias.copy_(torch.randn(m.offset.bias.shape, generator=generator)
                                    * DCN_OFFSET_BIAS_PX)
    return model


def dcnv3_calls(model, x) -> list:
    """The inputs of every DCNv3 sampling call of one eval-mode forward of
    `model` on the batch `x`: (x, offset, mask, (kernel, stride, pad, dilation,
    group, group_channels, offset_scale)) each."""
    import yolo_dual_tpu_torch.nn.dcn as dcn
    calls, sampling = [], dcn.dcnv3_sampling

    def record(*args):
        calls.append((*(t.detach() for t in args[:3]), args[3:]))
        return sampling(*args)
    mode = model.training
    dcn.dcnv3_sampling = record
    try:
        with torch.no_grad():
            model.eval()(x, decode=False)
    finally:
        dcn.dcnv3_sampling = sampling
        model.train(mode)
    return calls


def offset_spread(calls) -> dict:
    """Std and largest magnitude, in px, of the offsets of each DCNv3 call in
    `calls` (from dcnv3_calls), and the share of their samples with a corner
    outside their block's window under the forward's and the backward's launch
    plans."""
    out = {"std_px": [round(o.std().item(), 4) for _, o, _, _ in calls],
           "max_abs_px": [round(o.abs().max().item(), 4) for _, o, _, _ in calls]}
    for backward in (False, True):
        out["window_escapes_" + ("backward" if backward else "forward")] = [
            round(window_escapes(o, *x.shape[1:3], cfg[5], backward, *cfg[:5], cfg[6])["escapes"],
                  4) for x, o, _, cfg in calls]
    return out


def model_path(cfg: str, frames, card: str) -> dict:
    """Phases 4-6 for one model: slice, card against CPU, timing."""
    from yolo_dual_tpu_torch.engine.predictor import predict_images
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.ops.boxes import match_detections
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw

    # 4. slice: prediction on cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # torch's default for float32 convolutions
    gen = torch.Generator().manual_seed(0)
    model = SegmentationModel(cfg, device="cuda", generator=gen)
    n_dcn = sum(c for c in DCN_PATH_SHAPES.values()) if "dcnv3" in cfg else 0
    extra = {}
    if n_dcn:
        draw_dcnv3_heads(model, gen)
        extra["offset_heads"] = {"bias_px": DCN_OFFSET_BIAS_PX, "weight_gain": DCN_OFFSET_GAIN}
    calibrate_bn(model, make_frames(3, seed=1)).fuse()
    if n_dcn:
        extra["offsets"] = offset_spread(dcnv3_calls(
            model, letterbox_normalize(torch.from_numpy(frames[0])[None].cuda(), 640)))
    nm = model.model[-1].nm
    assert model.model[-1].npr == 128 and model.nc == 80
    predict_images(model, frames[:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                   device="cuda")  # warm-up: cuDNN plans, allocator, tap tables
    letterbox_normalize.launches = dcnv3_sampling.launches = 0
    dets = predict_images(model, frames, imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cuda")
    launches = {"letterbox_normalize": letterbox_normalize.launches,
                "dcnv3_sampling": dcnv3_sampling.launches}
    dt = predict_images.profiles
    assert len(dets) == N_FRAMES
    for i, d in enumerate(dets):
        if not (0 < len(d) <= 300 and d.shape[1] == 6 + nm and np.isfinite(d).all()):
            raise AssertionError(f"{cfg} frame {i}: detections shape {d.shape}, "
                                 f"finite {np.isfinite(d).all()}")
    want = {"letterbox_normalize": N_FRAMES, "dcnv3_sampling": n_dcn * N_FRAMES}
    if launches != want:
        raise AssertionError(f"{cfg}: kernel launches {launches} for {N_FRAMES} frames, "
                             f"expected {want}")
    stream = {k: v.t / N_FRAMES * 1e3 for k, v in zip(("pre_ms", "infer_ms", "post_ms"), dt)}
    stream["pre_h2d_ms"] = h2d_ms(frames)
    print(f"slice: {cfg} 640 fused, {N_FRAMES} frames on cuda, detections per frame "
          f"{[len(d) for d in dets]}, launches {launches} {json.dumps(extra)}", flush=True)

    # 5. card against CPU, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = copy.deepcopy(model).to("cpu")
    ref64 = copy.deepcopy(cpu_model).double() if n_dcn else None
    worst, failures, raw = {}, [], []
    for i in (1, 2):
        fr = torch.from_numpy(frames[i])[None]
        x = letterbox_normalize(fr, 640)
        with torch.inference_mode():
            lv_g, pr_g = model(letterbox_normalize(fr.cuda().contiguous(), 640), decode=False)
            lv_c, pr_c = cpu_model(x, decode=False)
            if ref64 is not None:
                raw.append(([t.cpu() for t in lv_g], lv_c,
                            [t.float() for t in ref64(x.double(), decode=False)[0]]))
        for name, g, c in [(f"level{j}", a, b) for j, (a, b) in enumerate(zip(lv_g, lv_c))] + \
                [("protos", pr_g, pr_c)]:
            # rtol 1e-3; entries near zero are held to 1e-3 of the map's largest magnitude
            try:
                torch.testing.assert_close(g.cpu(), c, rtol=1e-3, atol=1e-3 * c.abs().max().item())
            except AssertionError as e:
                failures.append(f"frame {i} {name}: {e}")
            worst[name] = max(worst.get(name, 0.0), (g.cpu() - c).abs().max().item())
    gpu2 = predict_images(model, frames[1:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cuda")
    cpu2 = predict_images(cpu_model, frames[1:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cpu")
    shares = [match_detections(c, g) for g, c in zip(gpu2, cpu2)]
    counts = [(len(g), len(c)) for g, c in zip(gpu2, cpu2)]
    for (ng, nc), share in zip(counts, shares):
        if not (abs(ng - nc) <= 0.02 * nc and share >= 0.98):
            failures.append(f"detections: n {ng} vs {nc}, matched {share}")
    # The DCNv3 model's random offset heads amplify float32 rounding (more
    # steeply the more the offsets follow the features), so both float32 runs
    # are also held to a float64 CPU run: shown, not enforced.
    anchored = []
    head_cpu = cpu_model.model[-1]
    for lv_g, lv_c, lv_d in raw:
        dg, dc, dd = (nms_from_raw(lv, head_cpu.anchors, head_cpu.strides, conf_thres=CONF_LOW,
                                   nm=nm) for lv in (lv_g, lv_c, lv_d))
        dg, dc, dd = (o[0, :int(n[0])].numpy() for o, n in (dg, dc, dd))
        anchored.append({"n": [len(dg), len(dc), len(dd)], "card_vs_f64": match_detections(dd, dg),
                         "cpu_f32_vs_f64": match_detections(dd, dc)})
    print(f"card vs cpu {cfg} (tf32 off): raw max abs diff {worst}, kept {[g for g, _ in counts]} "
          f"vs {[c for _, c in counts]}, matched share {shares}"
          + (f"; against the float64 CPU {anchored}" if anchored else ""), flush=True)
    if failures:
        raise AssertionError(f"{cfg} card vs CPU: " + "; ".join(failures))
    del cpu_model, ref64

    # 6. timing (torch defaults: cuDNN TF32 on for convs, matmul TF32 off)
    torch.backends.cudnn.allow_tf32 = True
    head = model.model[-1]
    x = torch.rand(32, 3, 640, 640, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(1))
    batched, single = {}, {}
    with torch.inference_mode():
        x1 = letterbox_normalize(torch.from_numpy(frames[0])[None].cuda(), 640)
        lv1, _ = model(x1, decode=False)
        single["forward_ms"] = cuda_ms(lambda: model(x1, decode=False), 20)
        single["nms_ms_conf1e-06"] = cuda_ms(
            lambda: nms_from_raw(lv1, head.anchors, head.strides, conf_thres=CONF_LOW,
                                 iou_thres=0.45, max_det=300, nm=nm, pre_nms_topk=1024), 20)
        levels, _ = model(x, decode=False)
        batched["forward_ms"] = cuda_ms(lambda: model(x, decode=False), 10)
        for conf in (0.25, CONF_LOW):
            batched[f"nms_ms_conf{conf:g}"] = cuda_ms(
                lambda: nms_from_raw(levels, head.anchors, head.strides, conf_thres=conf,
                                     iou_thres=0.45, max_det=300, nm=nm, pre_nms_topk=1024), 10)

            def step():
                lv, protos = model(x, decode=False)
                return nms_from_raw(lv, head.anchors, head.strides, conf_thres=conf,
                                    iou_thres=0.45, max_det=300, nm=nm, pre_nms_topk=1024)
            ms = cuda_ms(step, 10)
            batched[f"img_per_s_conf{conf:g}"] = 32 / (ms / 1e3)
    timing = {"model": cfg, "card": card, "tf32": {"cudnn_conv": True, "matmul": False},
              "stream_per_frame": stream, "bs1_640": single, "batched_bs32_640": batched}
    print("timing " + json.dumps(timing), flush=True)
    del model, x, levels
    torch.cuda.empty_cache()
    return launches



def train_batch(rng: np.random.Generator, bs: int, imgsz: int, device) -> dict:
    """One seeded synthetic batch as the JAX package's loader yields it: uint8
    NHWC images, targets (bs, M, 5) normalised [cls, x, y, w, h] with 1..M
    boxes an image, their mask (bs, M), and (bs, imgsz/4, imgsz/4)
    overlap-indexed masks, each instance an ellipse inside its box, targets
    ordered as encode_overlap_masks numbers the instances."""
    from yolo_dual_tpu_torch.losses.segment import encode_overlap_masks
    M, mh = TRAIN_MAX_BOXES, imgsz // 4
    targets = np.zeros((bs, M, 5), np.float32)
    tmask = np.zeros((bs, M), bool)
    masks = np.zeros((bs, mh, mh), np.float32)
    yy, xx = np.mgrid[0:mh, 0:mh] + 0.5
    for i in range(bs):
        n = int(rng.integers(1, M + 1))
        wh = rng.uniform(0.05, 0.5, (n, 2))
        xy = rng.uniform(wh / 2, 1 - wh / 2)
        boxes = np.concatenate([rng.integers(0, 80, (n, 1)), xy, wh], 1)
        inst = np.stack([((xx / mh - x) / (w / 2)) ** 2 + ((yy / mh - y) / (h / 2)) ** 2 <= 1
                         for _, x, y, w, h in boxes])
        masks[i], order = encode_overlap_masks(inst)
        targets[i, :n] = boxes[order]
        tmask[i, :n] = True
    image = rng.integers(0, 256, (bs, imgsz, imgsz, 3), dtype=np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in
            dict(image=image, targets=targets, tmask=tmask, masks=masks).items()}


def train_setup(model, bs: int, accumulate: int, count: int = 0):
    """Trainer and state for `model`: SGD with hyp.scratch-low (weight decay
    scaled by bs · accumulate / 64), the EMA, the overlap segment loss; the
    optimizer's inner step count starts at `count`."""
    from yolo_dual_tpu_torch.losses.segment import ComputeSegmentLoss
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg("hyp.scratch-low.json"))
    head = model.model[-1]
    loss = ComputeSegmentLoss(head.anchors, head.strides, model.nc, head.nm, hyp, overlap=True)
    opt = smart_optimizer(model, "SGD", hyp, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                          accumulate=accumulate, total_batch_size=bs)
    opt.count = count
    trainer = Trainer(model, loss, opt, ModelEMA(model), task="segment")
    return trainer, trainer.init_state()


def dcnv3_train_model(device="cuda"):
    """yolov5s-seg-dcnv3 at full width and depth with the predict phases'
    seeded weights, drawn DCNv3 heads and calibrated BatchNorm, unfused."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    gen = torch.Generator().manual_seed(0)
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device=device, generator=gen)
    draw_dcnv3_heads(model, gen)
    return calibrate_bn(model, make_frames(3, seed=1))


def train_path(card: str):
    """Phase 7: 8 checked micro-steps and 8 timed ones. Returns the launch
    counts, the inputs of the trained model's DCNv3 calls on the first batch
    (dcnv3_calls), and a function that profiles one accumulation cycle."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # torch's default for float32 convolutions
    model = dcnv3_train_model()
    trainer, state = train_setup(model, TRAIN_BS, ACCUMULATE)
    rng = np.random.default_rng(4)
    batches = [train_batch(rng, TRAIN_BS, TRAIN_IMGSZ, "cuda") for _ in range(TRAIN_MICRO_STEPS)]
    params = [p for p in model.parameters()]
    flat = lambda: torch.cat([p.detach().flatten() for p in params])  # noqa: E731
    torch.cuda.synchronize()
    letterbox_normalize.launches = dcnv3_sampling.launches = dcnv3_sampling_backward.launches = 0
    items, moved = [], []
    for batch in batches:
        before = flat()
        state, metrics = trainer.train_step(state, batch)
        moved.append(not torch.equal(before, flat()))
        items.append(metrics["items"].tolist())
    torch.cuda.synchronize()
    launches = {"letterbox_normalize": letterbox_normalize.launches,
                "dcnv3_sampling": dcnv3_sampling.launches,
                "dcnv3_sampling_backward": dcnv3_sampling_backward.launches}
    n_dcn = sum(DCN_PATH_SHAPES.values()) * TRAIN_MICRO_STEPS
    want = {"letterbox_normalize": 0, "dcnv3_sampling": n_dcn, "dcnv3_sampling_backward": n_dcn}
    boundaries = [(i + 1) % ACCUMULATE == 0 for i in range(TRAIN_MICRO_STEPS)]
    x = batches[0]["image"].permute(0, 3, 1, 2).float().div(255).contiguous()
    calls = dcnv3_calls(model, x)
    spread = offset_spread(calls)
    print(f"train: yolov5s-seg-dcnv3 bs {TRAIN_BS} {TRAIN_IMGSZ} px accumulate {ACCUMULATE}, "
          f"{TRAIN_MICRO_STEPS} micro-steps, items [lbox, lseg, lobj, lcls] {items}, "
          f"parameters moved {moved}, optimizer steps {state.optimizer.count}, "
          f"EMA updates {state.ema.updates}, launches {launches}; the model's offsets on the "
          f"first batch after the micro-steps {json.dumps(spread)}", flush=True)
    if not np.isfinite(items).all():
        raise AssertionError(f"train: a loss item is not finite: {items}")
    if launches != want:
        raise AssertionError(f"train: kernel launches {launches}, expected {want}")
    if moved != boundaries or state.ema.updates != TRAIN_MICRO_STEPS // ACCUMULATE:
        raise AssertionError(f"train: parameters moved at {moved}, expected {boundaries}; "
                             f"EMA updates {state.ema.updates}")

    # timing: 8 more micro-steps, each split by CUDA events, then 8 whole ones
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    split = []
    for batch in batches:
        e = [ev() for _ in range(4)]
        model.zero_grad(set_to_none=True)
        e[0].record()
        loss, _ = trainer.forward_loss(model, batch)
        e[1].record()
        loss.backward()
        e[2].record()
        trainer.apply_gradients(state)
        e[3].record()
        split.append(e)
    torch.cuda.synchronize()
    parts = np.array([[a.elapsed_time(b) for a, b in zip(e, e[1:])] for e in split])
    forward_ms = cuda_ms(lambda: model(x, decode=False), TRAIN_MICRO_STEPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    whole = cuda_ms(lambda: trainer.train_step(state, batches[0]), TRAIN_MICRO_STEPS, warmup=0)
    real = [i for i in range(TRAIN_MICRO_STEPS) if boundaries[i]]
    timing = {"model": "yolov5s-seg-dcnv3", "card": card, "bs": TRAIN_BS, "imgsz": TRAIN_IMGSZ,
              "accumulate": ACCUMULATE, "tf32": {"cudnn_conv": True, "matmul": False},
              "micro_step_ms": whole, "img_per_s": TRAIN_BS / (whole / 1e3),
              "forward_loss_ms": float(parts[:, 0].mean()), "forward_alone_ms": forward_ms,
              "backward_ms": float(parts[:, 1].mean()),
              "optimizer_ema_ms": float(parts[:, 2].mean()),
              "optimizer_ema_ms_on_real_steps": float(parts[real, 2].mean()),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("train timing " + json.dumps(timing), flush=True)
    torch.cuda.empty_cache()

    def profile():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True  # as the timed micro-steps ran
        return profile_steps(trainer, state, batches[:ACCUMULATE], whole)
    return launches, calls, profile


def profile_steps(trainer, state, batches, step_ms: float) -> dict:
    """torch.profiler over one accumulation cycle of train steps: the device
    time summed over the kernels it recorded, that sum over the profiled
    host-clock window (which the profiler's own overhead lengthens) and over
    the same number of unprofiled micro-steps of `step_ms` (the device's busy
    share), and the kernels that took most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            trainer.train_step(state, b)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731  (us -> ms)
    # the kernels themselves: the aten ops that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev(e) > 0]
    device_ms = sum(dev(e) for e in events)
    if not device_ms:
        return {"micro_steps": len(batches), "wall_ms": wall_ms, "device_ms": "not measured"}
    top = sorted(events, key=dev, reverse=True)[:15]
    return {"micro_steps": len(batches), "wall_ms": wall_ms, "device_ms": device_ms,
            "kernel_launches": sum(e.count for e in events),
            "busy_share_of_profiled_window": device_ms / wall_ms,
            "busy_share": device_ms / (len(batches) * step_ms),
            "top_ms": [[e.key[:90], round(dev(e), 4), e.count] for e in top]}


def train_card_vs_cpu():
    """Phase 8: one train step, bs 2 at 256 px, from the same weights and batch
    on the card and on the CPU in float32, TF32 off, past warmup so every group
    moves, and on the CPU in float64 as the anchor. Max pools (SPPF) route each
    gradient to an argmax, which can flip between near-tied values under any
    float32 rounding, so a float32 gradient or update may stand off the
    float64 one by what such a flip moves. The card must stand no further off
    it than the CPU's float32 does (the largest error of any tensor, relative
    to that tensor's largest magnitude: card ≤ 2 · CPU + 1e-3), the loss items
    must agree to 1e-4, and card and CPU within 1e-2 of each tensor's largest
    magnitude."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = dcnv3_train_model()
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = train_batch(np.random.default_rng(5), 2, 256, "cpu")
    batch64 = dict(batch, image=batch["image"].double() / 255.0, targets=batch["targets"].double())
    runs = {}
    for name, m, b in (("cuda", model, batch), ("cpu", cpu_model, batch),
                       ("cpu64", copy.deepcopy(cpu_model).double(), batch64)):
        trainer, state = train_setup(m, 2, 1, count=30000)
        start = {k: v.detach().clone() for k, v in m.named_parameters()}
        state, metrics = trainer.train_step(state, b)
        runs[name] = {"items": metrics["items"].cpu().double(),
                      "grads": {k: p.grad.cpu().double() for k, p in m.named_parameters()},
                      "updates": {k: (p.detach() - start[k]).cpu().double()
                                  for k, p in m.named_parameters()}}
    g, c, d = runs["cuda"], runs["cpu"], runs["cpu64"]

    def errs(a, b, key):  # per tensor: largest error relative to b's largest magnitude
        return sorted(((a[key][k] - v).abs().max().item() / v.abs().max().item(), k)
                      for k, v in b[key].items() if v.abs().max().item() > 1e-6)[::-1]
    out = {"items": {k: r["items"].tolist() for k, r in runs.items()},
           "items_max_rel_err": ((g["items"] - c["items"]).abs() / c["items"].abs()).max().item()}
    ok = out["items_max_rel_err"] <= 1e-4
    for key in ("grads", "updates"):
        e = {pair: errs(a, b, key) for pair, a, b in (("card_vs_cpu", g, c), ("card_vs_f64", g, d),
                                                       ("cpu_vs_f64", c, d))}
        out[key] = {pair: v[:3] for pair, v in e.items()}
        ok &= e["card_vs_f64"][0][0] <= 2 * e["cpu_vs_f64"][0][0] + 1e-3
        ok &= e["card_vs_cpu"][0][0] <= 1e-2
    print("train card vs cpu (bs 2, 256 px, tf32 off; worst 3 tensors, error over the "
          "tensor's largest magnitude): " + json.dumps(out), flush=True)
    if not ok:
        raise AssertionError(f"train card vs CPU: {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-times", metavar="ROOT", nargs="?",
                    const=str(Path(__file__).resolve().parent),
                    help="only K2's and K3's device times, of the package under ROOT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = Path(args.device_times or Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root))
    from yolo_dual_tpu_torch.kernels.build import library_path, load_library

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    if args.device_times:
        print(f"device times of the package under {root}", flush=True)
        shapes = [[b, *k] for b in (1, TRAIN_BS, 32) for k in DCN_PATH_SHAPES]
        device_phase({"x".join(map(str, s)): {"shape": s} for s in shapes},
                     {"x".join(map(str, s)): {"shape": s} for s in shapes if s[0] == TRAIN_BS})
        return 0

    # 2. build: one nvcc per source, all started together
    def build(name):
        t0 = time.perf_counter()
        load_library(name)
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    names = ("letterbox", "dcnv3", "dcnv3_bwd")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(build, names)))
    print("build: " + ", ".join(f"csrc/{n}.cu -> {library_path(n).name} in {t:.2f} s"
                                for n, t in secs.items())
          + f"; {time.perf_counter() - t0:.2f} s in all", flush=True)

    # 3. kernels against their plain versions
    lres = letterbox_phase()
    dres = dcnv3_phase()
    bres = dcnv3_bwd_phase()

    # 4-6. each model's prediction path; 7. the training path; 8. training, card vs CPU
    frames = make_frames(N_FRAMES)
    by_path = {cfg.removesuffix(".json"): model_path(cfg, frames, card) for cfg in MODELS}
    by_path["train yolov5s-seg-dcnv3"], trained, train_profile = train_path(card)
    train_card_vs_cpu()

    # 9. the DCNv3 kernels' own device times, on seeded and on the trained model's inputs;
    # then phase 7's profiled accumulation cycle: after a session of CPU and CUDA activity
    # the later sessions of the process missed or doubled kernel records
    device_phase(dres, bres)
    trained_inputs_phase(trained)
    del trained
    print("train profile " + json.dumps(train_profile()), flush=True)
    del train_profile

    # 10. kernels line: times are means over the launches of the main paths, each
    # launch weighted by the shape it ran at
    def total(kernel):
        return sum(p.get(kernel, 0) for p in by_path.values())

    def wmean(res, weights, key):
        return float(sum(res[n][key] * k for n, k in weights.items()) / sum(weights.values()))
    lcalls = {n: [list(MAIN_SHAPES)[i % len(MAIN_SHAPES)] for i in range(N_FRAMES)].count(n)
              for n in MAIN_SHAPES}
    # K2: 16 frames at batch 1 (prediction), 8 micro-steps at bs 16 (training)
    dcalls = {f"{b}x{h}x{w}x{c}": n * reps for (h, w, c), n in DCN_PATH_SHAPES.items()
              for b, reps in ((1, N_FRAMES), (TRAIN_BS, TRAIN_MICRO_STEPS))}
    bcalls = {f"{TRAIN_BS}x{h}x{w}x{c}": n * TRAIN_MICRO_STEPS for (h, w, c), n in DCN_PATH_SHAPES.items()}
    rows = (("letterbox_normalize", "letterbox.cu", "preprocess.py:91", lres, lcalls),
            ("dcnv3_sampling", "dcnv3.cu", "dcn_sampling.py:252", dres, dcalls),
            ("dcnv3_sampling_backward", "dcnv3_bwd.cu", "dcn_sampling.py:437", bres, bcalls))
    kernels = []
    for name, src, tpu, res, calls in rows:
        row = {"name": name, "route": "cuda", "source": f"yolo_dual_tpu_torch/csrc/{src}",
               "replaces": f"yolo_dual_tpu/kernels/{tpu}", "launches": total(name),
               "launches_by_path": {k: p.get(name, 0) for k, p in by_path.items()},
               "max_abs_err": max(r["max_abs_err"] for r in res.values())}
        row.update({k: wmean(res, calls, k) for k in ("ms", "plain_ms", "bound_ms")})
        if all(isinstance(r.get("device_ms"), float) for r in res.values()):  # phase 9's
            row["device_ms"] = wmean(res, calls, "device_ms")
        bound_by_bytes = "bytes_ms" not in next(iter(res.values())) or \
            wmean(res, calls, "bytes_ms") >= wmean(res, calls, "flops_ms")
        row["bound_by"] = "bytes" if bound_by_bytes else "operations"
        row["library_ms"] = wmean(res, calls, "library_ms")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
