#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (yolo_dual_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --device-times [ROOT]
    python3 chip_smoke.py --proof-spread RUNS

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
without a CUDA device it exits non-zero and prints no result. Phases, each of
which raises on failure:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/letterbox.cu, csrc/dcnv3.cu and csrc/dcnv3_bwd.cu from
   this checkout with nvcc, one process each, started together;
3. kernels: each kernel against its plain torch version at the shapes its
   main paths give it, with its time, the plain version's, one library call's
   (timed only) and the least time the card could take:
   - letterbox (K1) at the frames of LETTERBOX_CASES: the streamed 1080p, 720p
     and 480p frames, 32 x 720p, the validator's 32 x 480p with scaleup=False,
     an upscale, a small frame padded instead, fill 128, the semantic
     validator's and trainer's 16 x 720x960 at fill 128 and the learning
     proof's 4 x 96x96 (max abs error <= 1e-5; library: F.interpolate +
     F.pad + /255);
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
6b. validation (eval_path): yolov5s-seg as in 4, primed as the JAX
   dryrun primes it (solid masks), labels a val set of 64 seeded 480x640
   `.npy` frames with up to 8 of its own boxes a frame (4-vertex polygons);
   `segment.val.run` evaluates it at bs 32, --device-preprocess, conf 0.001,
   iou 0.6: the K1 count set to 0 just before reads 2 launches (one a batch),
   mAP50 of boxes and of masks exceed 0.05; a second run is timed (speed
   line, img/s, peak memory); one batch's forward, multi-label nms_from_raw
   (with its ranking and peak memory) and matching are timed; 8 frames at bs 8 through
   evaluate_segment on the card and on the CPU (TF32 off) agree within 0.01
   on each of the 8 metrics;
6c. the semantic flagship (semantic_path): resnet50.json (nc 12, 640 px,
   float32, full width and depth, seeded random weights, BatchNorm calibrated
   on 4 frames) on a seeded CamVid-style set of 48 720x960 `.npy` frames with
   JSON masks (class 11 present) under build/: `semantic.val.run` at bs 16 on
   the host route and on the device route (the K1 count set to 0 just before
   reads 3, one a batch; 0 on the host route), the speed line and img/s of
   each; semantic_preprocess on the card against its plain version (mask
   exact, image 1e-5); 4 frames card against CPU, TF32 off (scores within
   1e-3, argmax flips on at most 0.1% of the pixels, each within 1e-3 of a
   tie in the CPU's scores, the confusion matrices apart by at most twice
   the flips, mIoU within 1e-4, at least 4 classes predicted), and again
   with TF32 on, which must break each of those four limits; `semantic.predict.run` on 8
   frames at batch 1 (pre / infer / post ms a frame); the fused forward +
   argmax at bs 32 in img/s; one device-route val batch part by part; after
   phase 9 one more device-route val run under torch.profiler (the card's
   busy share);
6d. the semantic flagship trains (semantic_train_path): (a) one train step
   (accumulate 1, past warmup) of resnet50.json, BatchNorm calibrated, on 2
   frames at 320 px from the same weights on the card and on the CPU, the
   card once with TF32 convolutions off and once on: the loss, every
   parameter's update and the BatchNorm statistics against the CPU's, the
   float32 reading within SEM_STEP_*_TOL and the TF32 one beyond each; the
   micro-step at bs 16, 640 px, accumulate 4 on device-route batches, split
   into forward + loss / backward / optimizer + EMA (CUDA events), with its
   peak memory, and one bs-16 batch built on the host on each route; (b)
   `python -m yolo_dual_tpu_torch.semantic.train` in-process with
   resnet50.json (nc 12, 640 px, bs 16, --nbs 64, SGD, hyp.scratch-seg,
   dice, EMA) on 48 CamVid-style 720x960 frames and 16 val frames (6c's
   writer) under build/: 2 epochs on the device route (the counts set to 0
   just before read one K1 launch a training batch, 6), a bare --resume to a
   third (3), one host-route epoch (0), the native mask scanner loaded,
   results.csv finite, each epoch's train / val / save seconds; (c) the
   learning proof: the controlled golden of tests/test_semantic_golden.py
   (resnet50.json, the synthetic scene of 24 frames at 96 px, 30 epochs,
   bs 4, --nbs 4 --no-ema --no-augment, its hyp, seed 3) on the device
   route (K1 at 96 -> 96, 180 launches), under deterministic algorithms
   (torch.use_deterministic_algorithms, cuDNN's deterministic ones), reaches
   mIoU >= 0.9285 - 0.05;
   after phase 9 one more resumed device-route epoch under torch.profiler;
6e. the YOLO semantic family (yolo_semantic_path): yolov5_seg.json (18 DCNv2
   calls in three C3_DCN rows), yolov8_seg.json (C2f, three C2f_DCN) and
   yolov9_seg.json (five C3k2, GAM), each at nc 12, 640 px, full width and
   depth, seeded weights with the DCNv2 offset heads drawn, BatchNorm
   calibrated on 4 frames, on 48 + 16 CamVid-style 720x960 frames (6c's
   writer) under build/: (a) `semantic.val.run` at bs 16 on the device route
   (the K1 count set to 0 just before reads 3), its speed line and img/s;
   4 frames card against CPU under 6c's limits (TF32 only read);
   `semantic.predict.run` on 4 frames at batch 1; the fused forward + argmax
   at bs 32; (b) the micro-step at bs 16, accumulate 4, split as in 6d, its
   peak memory and, for yolov5_seg, the DCNv2 blocks' share of the forward
   and the backward (each block timed alone on its own inputs, CUDA events);
   one train step card against CPU at 320 px, the update limit earned from a
   float64 CPU step; (c) `semantic.train` in-process: one device-route epoch
   (K1 3, results.csv finite, last.pt loads strict), and for yolov5_seg a bare
   --resume to a second epoch against an uninterrupted 2-epoch run within
   RESUME_TOL (atomics); (d) each config's learning proof, as 6d (c), at or
   above its controlled golden (tests/test_semantic_golden.py:54-63) less
   0.05;
6f. the detect zoo (detect_zoo_path): the 17 configs of the SPP, attention,
   Ghost, Transformer and YOLOv3 modules and yolov5s as the control, each at
   its published width and depth, nc 80, 640 px, built by `build_model` on
   cuda (seeded weights, BatchNorm calibrated on 4 seeded frames) behind
   `AutoShape(fuse=True)`: 4 seeded frames of the MAIN_SHAPES sizes on the
   card and on the CPU (TF32 off): raw head maps within 1e-3 of each map's
   largest magnitude, detections at conf 0.05 paired (boxes within 0.05 px,
   confidences within 1e-4; near ties counted); the bs-32 fused forward +
   nms_from_raw in img/s and its peak memory, AutoShape at batch 1 and 8 in
   ms a call split into host letterbox / forward + NMS / rescale; no kernel
   launch on this path (AutoShape letterboxes on the host);
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
9. device times: each K1 case's, K2 shape's and K3 shape's own device time
   per launch from torch.profiler (at batch 1 the CUDA events of phase 3
   measure the host's wrapper as well; K1's call through the wrapper is timed
   by CUDA events again, and at batch 1 the host's share printed), after every
   timed path, as a profiler session can slow the host's later launches; then
   K2's and K3's device times on the inputs of the trained model's six DCNv3
   calls (bs 16, its offsets after phase 7) under window margins of 1 and 2
   px, each beside its window-escape share; K1's device time on phase 6b's
   eval batch (and, among the K1 cases, at the semantic validator's batch);
10. the train CLI (phase 10, `cli_train_path`): a seeded dataset written
   under build/phase10 (train: 32 x 480x640, 16 x 720x1280, 16 x 360x480
   `.npy` frames, so load_image shrinks and enlarges; val: 32 x 480x640; 1-8
   hexagon polygons a frame over bright boxes, 80 classes);
   `python -m yolo_dual_tpu_torch.segment.train` in-process with
   yolov5s-seg-dcnv3.json, hyp.scratch-low.json, 640 px, bs 16, device
   augmentation: 2 epochs in float32 (results.csv 2 rows of finite losses,
   last.pt and best.pt load strict; the counts set to 0 just before read 6
   K2 launches a training and a val forward and 6 K3 a micro-step: 72 and
   48), a bare --resume to 3 epochs (epochs 0, 1, 2), 1 epoch in bf16
   (finite, its first micro-step's loss within 5e-3 of float32's on the
   same batch and more than 10x as far from it as a float32 rerun's); the
   second epoch's img/s, every val pass and checkpoint write as the CLI
   logs them; one
   bs-16 batch built in this thread and timed by part, its tiles' H2D copy
   pinned and pageable, and mosaic_warp_hsv on it card against CPU (1e-4)
   and timed (CUDA events); after phase 9 one more resumed epoch under
   torch.profiler: the card's busy share of the epoch;
11. a JSON line of every kernel with its launches on the main paths, then the
   JSON result line.

`--proof-spread RUNS` runs phase 1 and the four learning proofs of 6d (c)
and 6e (d) only, each RUNS times with deterministic algorithms (as the phases
run them) and RUNS times without, with each run's best mIoU and a digest of
its last.pt; it fails when two deterministic runs of a config differ, and
prints no result line.

`--device-times ROOT` runs phase 1, phase 3's K1 cases (checked, and timed
through the wrapper) and phase 9's device times at every K1 case and DCNv3
path shape only, with the package of the checkout at ROOT (default: this one),
for instance the parent commit unpacked with `git archive`: the same
measurement of two versions in one call. It prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, which it reads when the process first
# uses it: the learning proofs run under torch.use_deterministic_algorithms (learning_proof)
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# tests/detection_matching.py pairs two runs' detections (phases 6 and 6f)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

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
EVAL_FRAMES, EVAL_BS, EVAL_SHAPE, EVAL_MAX_BOXES = 64, 32, (480, 640), 8
EVAL_CHECK_FRAMES = 8  # card against CPU, at bs 8


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


LETTERBOX_CASES = {  # name: ((B, H, W), out_size, fill, scaleup)
    "1080p": ((1, 1080, 1920), 640, 114.0, True),
    "720p": ((1, 720, 1280), 640, 114.0, True),
    "480p": ((1, 480, 640), 640, 114.0, True),
    "720p_bs32": ((32, 720, 1280), 640, 114.0, True),
    "val_480p_bs32_no_scaleup": ((32, 480, 640), 640, 114.0, False),  # the validator's
    "240p_upscale": ((1, 240, 320), 640, 114.0, True),
    "240p_no_scaleup": ((1, 240, 320), 640, 114.0, False),
    "720p_fill128": ((1, 720, 1280), 640, 128.0, True),  # semantic_preprocess's fill
    "semantic_720x960_bs16_fill128": ((16, 720, 960), 640, 128.0, True),  # semantic val's
    "semantic_train_96_bs4_fill128": ((4, 96, 96), 96, 128.0, True),  # the learning proof's
}


def frame_cycle(gen, x):
    """A function returning, call by call, `x` and seeded copies of its shape
    in turn, whose total exceeds the 50 MB L2, as a stream of new frames would."""
    xs = [x] + [torch.randint(0, 256, x.shape, dtype=torch.uint8, device="cuda", generator=gen)
                for _ in range(max(0, -(-64 * 2**20 // x.numel()) - 1))]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(xs)
        return xs[it["i"]]
    return nxt


def letterbox_phase():
    from yolo_dual_tpu_torch.kernels.preprocess import (
        letterbox_normalize, letterbox_normalize_reference)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in full f32
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, ((b, h, w), s, fill, scaleup) in LETTERBOX_CASES.items():
        x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        out = letterbox_normalize(x, s, fill=fill, scaleup=scaleup)
        ref = letterbox_normalize_reference(x, s, fill=fill, scaleup=scaleup)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (b, 3, s, s), (out.shape, ref.shape)
        err = (out - ref).abs().max().item()
        lib_err = (library_letterbox(x, s, fill, scaleup) - ref).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"letterbox {name}: max abs error {err} > 1e-5")
        nbytes = letterbox_bytes(b, h, w, s, scaleup)
        nxt = frame_cycle(gen, x)
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
        del nxt, x, out, ref
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

def device_phase(lres: dict, dres: dict, bres: dict):
    """Phase 9, after every timed path (a profiler session can slow the host's
    later launches): each K1, K2 and K3 case's own device time per launch from
    torch.profiler, on fresh seeded inputs (K1's cycled past the L2 as in phase
    3), into its result as `device_ms`. At batch 1 the CUDA events of phase 3
    measure the host's wrapper as well; for K1 the phase times the call
    through the wrapper by CUDA events again first, before any profiler
    session, as `wrapper_ms`, and prints the host's share at batch 1 (events
    less device time). `lres` maps names to results that need only `shape`
    [b, h, w, 3], `out_size`, `fill` and `scaleup`, `dres` and `bres` to
    results that need only a `shape` [b, h, w, c], and the phase calls nothing
    but the public wrappers, so it times another checkout's kernels alike when
    that checkout's package is the one imported."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    gen = torch.Generator(device="cuda").manual_seed(8)
    calls = {}
    for name, r in lres.items():
        b, h, w, _ = r["shape"]
        nxt = frame_cycle(gen, torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                                             device="cuda", generator=gen))
        s, fill, scaleup = r["out_size"], r["fill"], r["scaleup"]
        calls[name] = (lambda nxt=nxt, s=s, fill=fill, scaleup=scaleup:
                       letterbox_normalize(nxt(), s, fill=fill, scaleup=scaleup))
        r["wrapper_ms"] = cuda_ms(calls[name], 20 if b > 1 else 200)
    for name, r in lres.items():
        b = r["shape"][0]
        r["device_ms"] = profiled_kernel_ms(calls[name], "letterbox", 20 if b > 1 else 200)
        host = (f", host share {r['wrapper_ms'] - r['device_ms']:.5f} ms"
                if b == 1 and isinstance(r["device_ms"], float) else "")
        print(f"device letterbox {name}: {r['device_ms']} ms a launch, through the wrapper "
              f"{r['wrapper_ms']:.5f} ms (CUDA events){host}", flush=True)
    del calls
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


def make_frames(n: int, seed: int = 0, sizes=tuple(MAIN_SHAPES.values())):
    """n seeded uint8 RGB frames cycling `sizes` (1080p, 720p, 480p): smooth
    structure plus noise, made on the host as a camera or decoder would
    deliver them."""
    rng = np.random.default_rng(seed)
    frames = []
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


def calibrate_bn(model, frames, fill: float = 114.0):
    """Set every BatchNorm's running statistics to those of `frames` (a
    seeded calibration batch, letterboxed at `fill`). With identity
    statistics a random network's activations shrink layer by layer until
    every score ties with every other; calibrated, the scores spread as a
    trained network's do, so NMS, the argmax and the card-against-CPU
    comparisons have real work."""
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch gives its own statistics
    x = torch.cat([letterbox_normalize(torch.from_numpy(f)[None].cuda(), 640, fill=fill)
                   for f in frames])
    with torch.no_grad():
        model.train()(x)
    for bn, m in zip(bns, momenta):
        bn.momentum = m
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
    from detection_matching import match_detections
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



def prime_for_eval(model):
    """The JAX dryrun's priming (__graft_entry__.py:183-193): +3 on the
    objectness, +1 on the class and +2 on the coefficient biases of the detect
    convs, +2 on the proto cv3 BatchNorm bias, so the masks are solid and a
    random network's self-labels give box and mask TPs."""
    head = model.model[-1]
    with torch.no_grad():
        for conv in head.m:
            b = conv.bias.view(head.na, -1)
            b[:, 4] += 3.0
            b[:, 5:5 + head.nc] += 1.0
            b[:, 5 + head.nc:] += 2.0
        head.proto.cv3.bn.bias += 2.0
    return model


def write_val_set(root: Path, model, frames) -> Path:
    """A val set in the CLI's layout: root/images/*.npy frames, root/labels/*.txt
    with up to EVAL_MAX_BOXES of the model's own boxes a frame (conf 1e-4,
    wider and taller than 2 px), each written as a 4-vertex polygon."""
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_geometry, letterbox_normalize
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    h0, w0 = frames[0].shape[:2]
    r, (left, top) = letterbox_geometry(h0, w0, 640, scaleup=False)
    head = model.model[-1]
    with torch.no_grad():
        for i in range(0, len(frames), EVAL_BS):
            x = letterbox_normalize(torch.from_numpy(np.stack(frames[i:i + EVAL_BS])).cuda(), 640,
                                    scaleup=False)
            levels, _ = model.eval()(x, decode=False)
            out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=1e-4,
                                   iou_thres=0.6, max_det=50, nm=head.nm)
            for j, (o, n) in enumerate(zip(out.cpu().numpy(), nv.tolist())):
                d = o[:n]
                d = d[((d[:, 2] - d[:, 0]) > 2) & ((d[:, 3] - d[:, 1]) > 2)][:EVAL_MAX_BOXES]
                lines = []
                for row in d:
                    x1, x2 = np.clip((row[[0, 2]] - left) / r, 0, w0) / w0
                    y1, y2 = np.clip((row[[1, 3]] - top) / r, 0, h0) / h0
                    pts = [x1, y1, x2, y1, x2, y2, x1, y2]
                    lines.append(f"{int(row[5])} " + " ".join(f"{v:.6f}" for v in pts))
                np.save(root / "images" / f"{i + j:05d}.npy", frames[i + j])
                (root / "labels" / f"{i + j:05d}.txt").write_text("\n".join(lines))
    return root


def eval_path(card: str):
    """Phase 6b: the validation slice. yolov5s-seg, nc 80, 640 px, full width
    and depth, seeded random weights, BatchNorm calibrated, primed as the JAX
    dryrun primes it; a val set of EVAL_FRAMES seeded 480x640 frames labelled
    with the primed model's own boxes. segment.val.run evaluates it at bs 32
    through the letterbox kernel (--device-preprocess, conf 0.001, iou 0.6):
    the K1 counter set to 0 just before reads one launch a batch, and mAP50 of
    boxes and of masks exceed 0.05; a second run is timed. Then the parts of
    one batch's inference+NMS stage (forward, multi-label nms_from_raw with its
    peak memory and its ranking, matching and masks), and EVAL_CHECK_FRAMES
    frames at bs 8 through evaluate_segment on the card and on the CPU (TF32
    off): the 8 metrics agree within 0.01. Returns (launches, K1's eval batch
    for phase 9)."""
    import shutil
    import tempfile

    from yolo_dual_tpu_torch.data.dataset import YoloDataset
    from yolo_dual_tpu_torch.data.loader import Loader
    from yolo_dual_tpu_torch.engine.validator import PRE_NMS_TOPK, batch_matches, evaluate_segment
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    from yolo_dual_tpu_torch.segment import val

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frames = make_frames(EVAL_FRAMES, seed=5, sizes=(EVAL_SHAPE,))
    model = SegmentationModel("yolov5s-seg.json", device="cuda",
                              generator=torch.Generator().manual_seed(0))
    prime_for_eval(calibrate_bn(model, frames[:3]))
    build = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_val_", dir=build))
    try:
        root = write_val_set(tmp / "val", model, frames)
        weights = tmp / "yolov5s-seg-primed.pt"
        torch.save(model.state_dict(), weights)
        kw = dict(data=str(root), weights=str(weights), cfg="yolov5s-seg.json",
                  batch_size=EVAL_BS, imgsz=640, conf_thres=0.001, iou_thres=0.6, device="cuda",
                  device_preprocess=True)
        letterbox_normalize.launches = 0
        mean, _, times = val.run(**kw)
        launches = {"letterbox_normalize": letterbox_normalize.launches}
        n_batches = -(-EVAL_FRAMES // EVAL_BS)
        if launches["letterbox_normalize"] != n_batches:
            raise AssertionError(f"eval: {launches} letterbox launches for {n_batches} batches")
        if not (mean[2] > 0.05 and mean[6] > 0.05):
            raise AssertionError(f"eval: mAP50(B) {mean[2]}, mAP50(M) {mean[6]}: degenerate")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mean2, _, times2 = val.run(**kw)
        wall = time.perf_counter() - t0
        names = ("P(B)", "R(B)", "mAP50(B)", "mAP50-95(B)", "P(M)", "R(M)", "mAP50(M)",
                 "mAP50-95(M)")
        result = {"card": card, "frames": EVAL_FRAMES, "bs": EVAL_BS, "launches": launches,
                  "metrics": dict(zip(names, map(float, mean))),
                  "speed_ms_per_image": dict(zip(("pre", "inference+nms", "post"), times2)),
                  "img_per_s_timed_stages": 1e3 / sum(times2),
                  "img_per_s_run": EVAL_FRAMES / wall, "run_s": wall,
                  "peak_memory_bytes_run": torch.cuda.max_memory_allocated(),
                  "second_run_same_metrics": bool(np.allclose(mean, mean2, atol=0, rtol=0))}

        # the inference+NMS stage of one eval batch, part by part: the forward, the
        # multi-label NMS (with its peak memory and its ranking of the scores: a
        # stable sort, and torch.topk, which fixes no order among ties, as yardstick),
        # the matching
        model.fuse()
        head = model.model[-1]
        x = letterbox_normalize(torch.from_numpy(np.stack(frames[:EVAL_BS])).cuda(), 640,
                                scaleup=False)
        sample = YoloDataset(str(root / "images"), imgsz=640, device_preprocess=True)
        gt = {k: torch.from_numpy(np.stack([sample[i][k] for i in range(EVAL_BS)])).cuda()
              for k in ("targets", "tmask", "masks")}
        with torch.inference_mode():
            levels, protos = model(x, decode=False)

            def nms():
                return nms_from_raw(levels, head.anchors, head.strides, conf_thres=0.001,
                                    iou_thres=0.6, multi_label=True, max_det=300, nm=head.nm,
                                    pre_nms_topk=PRE_NMS_TOPK)
            out, n_valid = nms()
            result["stage_bs32_ms"] = {
                "forward": cuda_ms(lambda: model(x, decode=False), 10),
                "nms_multi_label": cuda_ms(nms, 10),
                "matching_and_masks": cuda_ms(lambda: batch_matches(
                    out, n_valid, protos, gt["targets"], gt["tmask"], gt["masks"], 640, 640,
                    head.nm), 10)}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            nms()
            peak = torch.cuda.max_memory_allocated() - base
            flat = torch.rand(EVAL_BS, sum(p[0, ..., 0].numel() for p in levels) * head.nc,
                              device="cuda")
            result["nms_multi_label_bs32"] = {
                "peak_extra_bytes": peak, "kept_per_image": n_valid.tolist(),
                "scores": list(flat.shape),
                "stable_sort_ms": cuda_ms(lambda: flat.sort(dim=1, descending=True,
                                                           stable=True), 10),
                "torch_topk_ms": cuda_ms(lambda: flat.topk(PRE_NMS_TOPK, dim=1), 10)}
            del flat, levels, protos, out, gt
        print("eval " + json.dumps(result), flush=True)

        # card against CPU, TF32 off, on the first frames at bs 8
        torch.backends.cudnn.allow_tf32 = False
        sub = tmp / "val8"
        for d in ("images", "labels"):
            (sub / d).mkdir(parents=True)
            for f in sorted((root / d).iterdir())[:EVAL_CHECK_FRAMES]:
                shutil.copy(f, sub / d / f.name)
        got = {}
        for dev in ("cuda", "cpu"):
            m = SegmentationModel("yolov5s-seg.json", device=dev)
            m.load_state_dict(torch.load(weights, map_location=dev, weights_only=True))
            loader = Loader(YoloDataset(str(sub / "images"), imgsz=640, device_preprocess=True),
                            batch_size=8)
            got[dev] = np.asarray(evaluate_segment(m, loader, 80, conf_thres=0.001,
                                                   iou_thres=0.6, device=dev)[0], np.float64)
        diff = np.abs(got["cuda"] - got["cpu"])
        print(f"eval card vs cpu ({EVAL_CHECK_FRAMES} frames, bs 8, tf32 off): card "
              f"{got['cuda'].round(5).tolist()} cpu {got['cpu'].round(5).tolist()} "
              f"max abs diff {diff.max():.3g}", flush=True)
        if not diff.max() <= 0.01:
            raise AssertionError(f"eval card vs CPU: metrics differ by {diff.max()} > 0.01")
        torch.backends.cudnn.allow_tf32 = True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batch = torch.from_numpy(np.stack(frames[:EVAL_BS])).cuda()
    del model
    torch.cuda.empty_cache()
    return launches, batch


# Phase 6c: the semantic flagship. CamVid's frames (720x960) and classes (12).
SEM_FRAMES, SEM_SHAPE, SEM_BS, SEM_NC = 48, (720, 960), 16, 12
SEM_CHECK_FRAMES, SEM_PREDICT_FRAMES, SEM_INFER_BS = 4, 8, 32
# card against CPU on SEM_CHECK_FRAMES frames, TF32 off: scores within SEM_SCORE_TOL,
# argmax flips on at most SEM_FLIP_SHARE of the pixels, each a near tie of the CPU's
# scores (top-two gap within SEM_NEAR_TIE), and mIoU within SEM_MIOU_TOL. Each limit
# lies between the TF32-off reading and the TF32-on one, which must break every limit
# (on an NVIDIA H100 80GB HBM3, 700 W: 3.15e-4 / 0.271, 2.04e-4 / 0.173, 1.18e-4 /
# 0.286, 9.3e-7 / 6.8e-4; PERF.md)
SEM_SCORE_TOL, SEM_FLIP_SHARE, SEM_NEAR_TIE, SEM_MIOU_TOL = 1e-3, 1e-3, 1e-3, 1e-4


def camvid_like_mask(rng, h: int, w: int) -> np.ndarray:
    """A seeded street-scene class map of CamVid's 12 classes: sky over
    buildings over road, pavement at the sides, trees, poles, signs, fences,
    cars, pedestrians and cyclists as boxes, and an unlabelled (11) box."""
    yy, xx = np.mgrid[0:h, 0:w]
    horizon = h * rng.uniform(0.3, 0.45) + 30 * np.sin(xx / rng.uniform(60, 200))
    ground = h * rng.uniform(0.6, 0.7)
    mask = np.where(yy < horizon, 0, np.where(yy < ground, 1, 3)).astype(np.uint8)
    side = w * rng.uniform(0.1, 0.25)
    mask[(yy >= ground) & ((xx < side - (yy - ground)) | (xx > w - side + (yy - ground)))] = 4
    for cls, n, (bh, bw) in ((5, 3, (0.3, 0.15)), (2, 3, (0.4, 0.01)), (6, 2, (0.05, 0.04)),
                             (7, 2, (0.08, 0.3)), (8, 4, (0.15, 0.2)), (9, 3, (0.2, 0.04)),
                             (10, 2, (0.15, 0.06)), (11, 1, (0.1, 0.1))):
        for _ in range(n):
            bh_, bw_ = int(h * bh * rng.uniform(0.5, 1.5)) + 2, int(w * bw * rng.uniform(0.5, 1.5)) + 2
            y0, x0 = rng.integers(0, h - bh_), rng.integers(0, w - bw_)
            mask[y0:y0 + bh_, x0:x0 + bw_] = cls
    return mask


def write_semantic_set(root: Path, n: int, seed: int):
    """The JSON dataset layout (data/json_dataset.py): root/images/*.npy RGB
    uint8 frames of SEM_SHAPE and root/json/*.json dense masks. Each frame is
    its mask in the CamVid palette, shaded and with noise. Returns (images,
    json) directories."""
    from yolo_dual_tpu_torch.utils.plots import CAMVID_PALETTE
    rng = np.random.default_rng(seed)
    img_dir, json_dir = root / "images", root / "json"
    img_dir.mkdir(parents=True)
    json_dir.mkdir()
    h, w = SEM_SHAPE
    shade = 0.8 + 0.4 * np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    for i in range(n):
        mask = camvid_like_mask(rng, h, w)
        frame = CAMVID_PALETTE[mask].astype(np.float32) * shade \
            + rng.normal(0, 12, (h, w, 3)).astype(np.float32)
        np.save(img_dir / f"{i:05d}.npy", np.clip(frame, 0, 255).astype(np.uint8))
        (json_dir / f"{i:05d}.json").write_text(json.dumps(
            {"filename": f"{i:05d}.png", "shape": [h, w], "dtype": "uint8", "class_names": [],
             "mask_data": mask.reshape(-1).tolist()}, separators=(",", ":")))
    return img_dir, json_dir


def semantic_card_vs_cpu(model, frames, masks, tf32_must_break: bool = True) -> dict:
    """SEM_CHECK_FRAMES frames through semantic_preprocess and the fused model
    on the CPU and on the card, the card's convolutions once in float32 (cuDNN
    TF32 off) and once in TF32: scores, argmax flips (with the CPU's top-two
    gap), confusion matrices and mIoU against the CPU's. The float32 reading
    must lie within the limits, and with `tf32_must_break` the TF32 one beyond
    each of them, so the check tells float32 from TF32; the matrices differ by
    at most two counts a flipped pixel (the masks agree). Leaves TF32 on,
    torch's default."""
    from yolo_dual_tpu_torch.kernels.preprocess import semantic_preprocess
    from yolo_dual_tpu_torch.metrics.seg import SegmentationConfusionMatrix
    im, mk = torch.from_numpy(np.stack(frames)), torch.from_numpy(np.stack(masks))

    def run(m, dev):
        with torch.inference_mode():
            x, gt = semantic_preprocess(im.to(dev), mk.to(dev), 640)
            scores = m(x).float().cpu()
        cm = SegmentationConfusionMatrix(SEM_NC, ignore_index=11)
        cm.update(scores.argmax(1).numpy(), gt.cpu().numpy())
        return scores, cm

    cpu, cm_cpu = run(copy.deepcopy(model).to("cpu"), "cpu")
    top2 = cpu.topk(2, dim=1).values
    readings = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        card, cm_card = run(model, "cuda")
        flips = card.argmax(1) != cpu.argmax(1)
        gap = (top2[:, 0] - top2[:, 1])[flips]
        miou = (float(cm_card.compute_iou()[0]), float(cm_cpu.compute_iou()[0]))
        r = {"frames": len(frames), "pixels": flips.numel(), "flips": int(flips.sum()),
             "flip_share": float(flips.float().mean()),
             "largest_gap_of_a_flip": float(gap.max()) if len(gap) else 0.0,
             "cm_l1": int(np.abs(cm_card.matrix - cm_cpu.matrix).sum()),
             "miou_card_cpu": miou, "score_max_abs_diff": float((card - cpu).abs().max()),
             "classes_predicted": sorted(set(card.argmax(1).unique().tolist()))}
        r["within"] = {"score": r["score_max_abs_diff"] <= SEM_SCORE_TOL,
                       "flip_share": r["flip_share"] <= SEM_FLIP_SHARE,
                       "near_tie": r["largest_gap_of_a_flip"] <= SEM_NEAR_TIE,
                       "miou": abs(miou[0] - miou[1]) <= SEM_MIOU_TOL}
        readings["tf32_on" if tf32 else "tf32_off"] = r
        print(f"semantic card vs cpu (tf32 {'on' if tf32 else 'off'}) " + json.dumps(r),
              flush=True)
    torch.backends.cudnn.allow_tf32 = True
    off, on = readings["tf32_off"], readings["tf32_on"]
    limits = (f"score {SEM_SCORE_TOL}, flip share {SEM_FLIP_SHARE}, near tie {SEM_NEAR_TIE}, "
              f"mIoU {SEM_MIOU_TOL}")
    if not (all(off["within"].values()) and off["cm_l1"] <= 2 * off["flips"]):
        raise AssertionError(f"semantic card vs CPU beyond the limits ({limits}): {off}")
    if tf32_must_break and any(on["within"].values()):
        raise AssertionError(f"semantic card vs CPU: TF32 convolutions pass a limit "
                             f"({limits}), which then does not tell float32 from TF32: {on}")
    if len(off["classes_predicted"]) < 4:
        raise AssertionError(f"semantic: the argmax holds {off['classes_predicted']}: degenerate")
    return readings


def host_ms(fn, iters: int = 5) -> float:
    """Mean host-clock ms per call of `fn`, synchronized before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def semantic_batch_parts(model, samples, weights) -> dict:
    """One device-route val batch of semantic.val (bs SEM_BS), part by part:
    the copy of the raw frames and masks to the card, semantic_preprocess,
    the fused forward, the argmax and its copy back, the host confusion
    matrix, the loss on the card; and the CLI's model build + weight load."""
    from yolo_dual_tpu_torch.kernels.preprocess import semantic_preprocess
    from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
    from yolo_dual_tpu_torch.metrics.seg import SegmentationConfusionMatrix
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    raw = np.stack([s["image_raw"] for s in samples[:SEM_BS]])
    masks = np.stack([s["mask_raw"] for s in samples[:SEM_BS]])
    loss_fn, cm = SemanticSegLoss(SEM_NC), SegmentationConfusionMatrix(SEM_NC, 11)
    with torch.inference_mode():
        im, mk = torch.from_numpy(raw).cuda(), torch.from_numpy(masks).cuda()
        x, gt = semantic_preprocess(im, mk, 640)
        out = model(x)
        pred, gt_h = out.argmax(1).cpu().numpy(), gt.cpu().numpy()
        parts = {"h2d_frames_and_masks": host_ms(lambda: (torch.from_numpy(raw).cuda(),
                                                          torch.from_numpy(masks).cuda())),
                 "semantic_preprocess": cuda_ms(lambda: semantic_preprocess(im, mk, 640), 10),
                 "forward": cuda_ms(lambda: model(x), 5),
                 "argmax_and_d2h": host_ms(lambda: out.argmax(1).cpu()),
                 "confusion_matrix_host": host_ms(lambda: cm.update(pred, gt_h)),
                 "loss": cuda_ms(lambda: loss_fn(out, gt), 5)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = SemanticSegModel("resnet50.json", device="cuda", generator=torch.Generator().manual_seed(0))
    m.load_state_dict(torch.load(weights, map_location="cuda", weights_only=True), strict=True)
    torch.cuda.synchronize()
    parts["model_build_and_load_once"] = (time.perf_counter() - t0) * 1e3
    del m
    return parts


def semantic_path(card: str):
    """Phase 6c: the semantic flagship through its CLIs. resnet50.json (nc 12,
    640 px, float32, full width and depth), seeded random weights, BatchNorm
    calibrated on 4 of the set's frames letterboxed at fill 128; a seeded
    CamVid-style set of SEM_FRAMES 720x960 `.npy` frames and JSON masks
    (class 11 present) under build/. `semantic.val.run` at bs 16 on the host
    route and on the device route (--device-preprocess): the K1 count set to
    0 just before the device route reads one launch a batch. Then
    semantic_preprocess on the card against its plain version on one batch,
    SEM_CHECK_FRAMES frames card against CPU (semantic_card_vs_cpu),
    `semantic.predict.run` on SEM_PREDICT_FRAMES frames at batch 1 (after 2
    warm-up frames) with its pre / infer / post ms a frame, the fused
    forward + argmax at bs 32 in img/s (bench.py:194's measurement), and one
    device-route val batch part by part (semantic_batch_parts). Returns the
    device route's launches and a function that profiles one more
    device-route val run (after phase 9, as the training profiles) and then
    removes the set."""
    import shutil
    import tempfile

    from yolo_dual_tpu_torch.data.json_dataset import JSONSegmentDataset
    from yolo_dual_tpu_torch.kernels.preprocess import (
        letterbox_normalize, semantic_preprocess, semantic_preprocess_reference)
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    from yolo_dual_tpu_torch.semantic import predict, val

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    build = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_semantic_", dir=build))
    try:
        t0 = time.perf_counter()
        img_dir, json_dir = write_semantic_set(tmp / "camvid", SEM_FRAMES, seed=21)
        ds = JSONSegmentDataset(img_dir, json_dir, 640, device_preprocess=True)
        samples = [ds[i] for i in range(len(ds))]  # parses every JSON once: .json.npy caches
        set_up_s = time.perf_counter() - t0
        model = SemanticSegModel("resnet50.json", device="cuda",
                                 generator=torch.Generator().manual_seed(0))
        calibrate_bn(model, [s["image_raw"] for s in samples[:4]], fill=128.0)
        weights = tmp / "resnet50-calibrated.pt"
        torch.save(model.state_dict(), weights)
        model.fuse()
        kw = dict(weights=str(weights), cfg="resnet50.json", img_dir=str(img_dir),
                  json_dir=str(json_dir), imgsz=640, batch_size=SEM_BS, nc=SEM_NC,
                  device="cuda")
        result = {"card": card, "frames": SEM_FRAMES, "shape": list(SEM_SHAPE), "bs": SEM_BS,
                  "set_up_s": set_up_s}
        for route, dp in (("host", False), ("device", True)):
            letterbox_normalize.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (miou, vloss, _, _), iou, (ms,) = val.run(device_preprocess=dp, **kw)
            wall = time.perf_counter() - t0
            result[route] = {"miou": float(miou), "val_loss": float(vloss),
                             "speed_ms_per_image": ms, "img_per_s_timed": 1e3 / ms,
                             "img_per_s_run": SEM_FRAMES / wall, "run_s": wall,
                             "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                             "k1_launches": letterbox_normalize.launches}
            print(f"semantic val {route} route: speed {ms:.3f} ms an image, "
                  f"{1e3 / ms:.1f} img/s timed, {SEM_FRAMES / wall:.1f} img/s a whole run, "
                  f"mIoU {miou:.4f}, val loss {vloss:.4f}", flush=True)
            if not (np.isfinite(vloss) and 0 <= miou <= 1):
                raise AssertionError(f"semantic val {route}: mIoU {miou}, loss {vloss}")
        launches = {"letterbox_normalize": result["device"]["k1_launches"]}
        n_batches = -(-SEM_FRAMES // SEM_BS)
        if result["host"]["k1_launches"] != 0 or launches["letterbox_normalize"] != n_batches:
            raise AssertionError(f"semantic val: K1 launches host {result['host']['k1_launches']}"
                                 f", device {launches['letterbox_normalize']}; expected 0 and "
                                 f"{n_batches}")

        # semantic_preprocess on the card against its plain version, one val batch
        im = torch.from_numpy(np.stack([s["image_raw"] for s in samples[:SEM_BS]])).cuda()
        mk = torch.from_numpy(np.stack([s["mask_raw"] for s in samples[:SEM_BS]])).cuda()
        gen = torch.Generator(device="cuda").manual_seed(3)
        aug = dict(flip=torch.rand(SEM_BS, device="cuda", generator=gen) < 0.5,
                   bright=0.8 + 0.4 * torch.rand(SEM_BS, device="cuda", generator=gen),
                   contr=0.8 + 0.4 * torch.rand(SEM_BS, device="cuda", generator=gen))
        (gi, gm), (ri, rm) = (f(im, mk, 640, **aug) for f in (semantic_preprocess,
                                                              semantic_preprocess_reference))
        err = (gi - ri).abs().max().item()
        if not (torch.equal(gm, rm) and err <= 1e-5):
            raise AssertionError(f"semantic_preprocess on the card: image error {err}, "
                                 f"masks equal {torch.equal(gm, rm)}")
        result["semantic_preprocess_max_abs_err"] = err
        del im, mk, gi, gm, ri, rm

        # card against CPU, the card's convolutions in float32 and in TF32
        result["card_vs_cpu"] = semantic_card_vs_cpu(
            model, [s["image_raw"] for s in samples[:SEM_CHECK_FRAMES]],
            [s["mask_raw"] for s in samples[:SEM_CHECK_FRAMES]])

        # the predictor at batch 1: 2 warm-up frames, then SEM_PREDICT_FRAMES timed
        frames = sorted(img_dir.iterdir())
        for name, n in (("warm", 2), ("predict", SEM_PREDICT_FRAMES)):
            (tmp / name).mkdir()
            for f in frames[:n]:
                shutil.copy(f, tmp / name / f.name)
        predict.run(weights=str(weights), source=str(tmp / "warm"), project=str(tmp),
                    name="p0", device="cuda")
        metrics, out_dir, speed = predict.run(weights=str(weights), source=str(tmp / "predict"),
                                              gt_json_dir=str(json_dir), project=str(tmp),
                                              name="p1", device="cuda")
        n_out = len(list(out_dir.iterdir()))
        if n_out != 3 * SEM_PREDICT_FRAMES or not np.isfinite(metrics["mIoU"]):
            raise AssertionError(f"semantic predict: {n_out} outputs, mIoU {metrics['mIoU']}")
        result["predict_bs1_ms_per_frame"] = dict(zip(("pre", "infer", "post"), speed))
        result["predict_miou"] = float(metrics["mIoU"])
        print(f"semantic predict {SEM_PREDICT_FRAMES} frames at batch 1: {speed[0]:.3f} / "
              f"{speed[1]:.3f} / {speed[2]:.3f} ms pre / infer / post a frame", flush=True)

        # the fused forward + argmax at bs 32 (cuDNN TF32 on, torch's default)
        x = torch.rand(SEM_INFER_BS, 3, 640, 640, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(4))
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x).argmax(1), 10)
        result["fused_forward_argmax_bs32"] = {"ms": ms, "img_per_s": SEM_INFER_BS / ms * 1e3}
        print(f"semantic fused forward + argmax at bs {SEM_INFER_BS}: {ms:.3f} ms, "
              f"{SEM_INFER_BS / ms * 1e3:.1f} img/s", flush=True)
        del x
        result["val_batch_parts_ms"] = semantic_batch_parts(model, samples, weights)
        print("semantic " + json.dumps(result), flush=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    del model, samples
    torch.cuda.empty_cache()

    def profile():
        """One more device-route semantic.val run under torch.profiler: the
        card's busy share of the run's wall clock (model build and load, the
        loader, the batches, the host confusion matrix)."""
        from torch.profiler import ProfilerActivity, profile as torch_profile
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                val.run(device_preprocess=True, **kw)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        return {"card": card, "run_wall_ms_profiled": wall_ms,
                "device_ms": device_ms if device_ms else "not measured",
                "busy_share": device_ms / wall_ms if device_ms else "not measured",
                "idle_share": 1 - device_ms / wall_ms if device_ms else "not measured",
                "top_ms": [[e.key[:80], round(e.self_device_time_total / 1e3, 3), e.count]
                           for e in top]}
    return launches, profile


# Phase 6d: the semantic flagship trains (semantic.train). resnet50.json at full width,
# hyp.scratch-seg, SGD, dice, EMA, bs 16, 640 px, accumulate 4 (--nbs 64), on
# SEM_TRAIN_FRAMES + SEM_VAL_FRAMES CamVid-style 720x960 frames (phase 6c's writer).
SEM_TRAIN_FRAMES, SEM_VAL_FRAMES, SEM_TRAIN_EPOCHS = 48, 16, 2
SEM_ACCUMULATE = max(round(64 / SEM_BS), 1)
SEM_STEP_FRAMES, SEM_STEP_SIZE = 2, 320  # (a): one step, card against CPU
# (a)'s limits, each between the card's float32 reading and its TF32 one, which must break
# each: the loss (relative), every parameter's update and every BatchNorm statistic (the
# largest error over the CPU tensor's largest magnitude). On an NVIDIA H100 80GB HBM3,
# 700 W, float32 / TF32 read 0 / 1.0e-4, 0.173 / 1.51, 1.8e-6 / 1.9e-3 (PERF.md); the
# float32 update error is the deep softmax graph's conditioning, and the card's float32
# update must stand no further from a float64 CPU step than twice the CPU's float32 one
SEM_STEP_LOSS_TOL, SEM_STEP_UPDATE_TOL, SEM_STEP_BN_TOL = 1e-5, 0.5, 1e-4
# 6e (c): a resumed 2-epoch yolov5_seg run against an uninterrupted one; the DCNv2 backward's
# scatter-adds (index_add_) use atomics, so the two differ in float32 rounding: results.csv's
# loss columns (largest gap over their largest value), mIoU and fitness (absolute), val loss
RESUME_TOL = {"loss_rel": 1e-3, "miou_abs": 1e-2, "val_loss_rel": 1e-3}
# (c): the controlled golden of tests/test_semantic_golden.py:54-135 (resnet50.yaml: 0.9285,
# slack 0.05): 24 frames of 96 px, 30 epochs, bs 4, --nbs 4 --no-ema --no-augment, seed 3,
# its hyp (lr0 0.05, short warmup); here on the device route (K1 at 96 -> 96, the identity)
SEM_GOLDEN_FLOOR = 0.9285 - 0.05
GOLDEN_EPOCHS = 30
SEM_GOLDEN_HYP = dict(lr0=0.05, lrf=0.2, momentum=0.9, weight_decay=5e-4, warmup_epochs=1.0,
                      warmup_momentum=0.8, warmup_bias_lr=0.1, ema_decay=0.95, ema_tau=50.0)


def semantic_train_setup(model, bs: int, accumulate: int, steps_per_epoch: int, count: int = 0):
    """Trainer and state of semantic.train's defaults for `model`: SGD with
    hyp.scratch-seg (weight decay scaled by bs · accumulate / 64), the EMA,
    the dice loss; the optimizer's inner step count starts at `count`."""
    from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg("hyp.scratch-seg.json"))
    opt = smart_optimizer(model, "SGD", hyp, epochs=100, steps_per_epoch=steps_per_epoch,
                          accumulate=accumulate, total_batch_size=bs)
    opt.count = count
    trainer = Trainer(model, SemanticSegLoss(SEM_NC), opt, ModelEMA(model), task="semantic")
    return trainer, trainer.init_state()


def semantic_step_card_vs_cpu(frames, masks, cfg: str = "resnet50.json", earned: bool = False,
                              prepare=None) -> dict:
    """(a): one train step (accumulate 1, past warmup so every group moves) of
    `cfg`, BatchNorm calibrated (after `prepare(model)` where given), on
    SEM_STEP_FRAMES frames resized and padded to SEM_STEP_SIZE on the host,
    from the same weights on the CPU (in float32, and in float64 as the
    anchor) and on the card, the card's convolutions once in float32 (cuDNN
    TF32 off) and once in TF32: the loss, the parameters after the step and
    their updates, the BatchNorm statistics. The float32 reading must lie
    within the limits, and the card's float32 updates stand no further from
    the float64 step than twice the CPU's float32 ones. The limits are
    SEM_STEP_*_TOL and the TF32 reading must break each; or, `earned`, the
    update limit is what the float64 run gives the config (twice the CPU's
    float32 distance from float64, plus 1e-3) and TF32 is only read. Leaves
    TF32 on, torch's default."""
    from yolo_dual_tpu_torch.data.json_dataset import resize_and_pad
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = SemanticSegModel(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    if prepare is not None:
        prepare(model)
    calibrate_bn(model, frames[:4], fill=128.0)
    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    pairs = [resize_and_pad(f, m.astype(np.uint8), SEM_STEP_SIZE)[:2]
             for f, m in zip(frames[:SEM_STEP_FRAMES], masks[:SEM_STEP_FRAMES])]
    batch = {"image": np.stack([p[0] for p in pairs]),
             "mask": np.stack([p[1] for p in pairs]).astype(np.int32)}
    batch64 = {"image": torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).double() / 255,
               "mask": batch["mask"]}
    runs = {}
    for name, dev, tf32 in (("cpu", "cpu", False), ("cpu64", "cpu", False),
                            ("card_f32", "cuda", False), ("card_tf32", "cuda", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        m = SemanticSegModel(cfg, device=dev)
        m.load_state_dict(start)
        if name == "cpu64":
            m.double()
        trainer, state = semantic_train_setup(m, SEM_STEP_FRAMES, 1, steps_per_epoch=3, count=100)
        state, metrics = trainer.train_step(state, batch64 if name == "cpu64" else batch)
        runs[name] = {"items": metrics["items"].cpu().double(),
                      "sd": {k: v.detach().cpu().double() for k, v in m.state_dict().items()}}
        del m, trainer, state
    torch.backends.cudnn.allow_tf32 = True
    params = [k for k in start if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    cpu = runs["cpu"]

    def worst(a, b, keys, base=None):  # largest error over the tensor's largest magnitude
        out = []
        for k in keys:
            x, y = (a[k] - base[k], b[k] - base[k]) if base else (a[k], b[k])
            if y.abs().max() > 0:
                out.append(((x - y).abs().max().item() / y.abs().max().item(), k))
        return sorted(out)[::-1]
    base = {k: v.double() for k, v in start.items()}
    f64 = runs["cpu64"]["sd"]
    # a parameter whose gradient is zero in exact arithmetic (a bias that feeds a train-mode
    # BatchNorm, as DCNv2's does) moves by rounding alone: float64 moves it by < 1e-6 of the
    # step's largest update, and its error over its own largest move means nothing
    moves = {k: (f64[k] - base[k]).abs().max().item() for k in params}
    unmoved = sorted(k for k in params if moves[k] <= 1e-6 * max(moves.values()))
    params = [k for k in params if k not in unmoved]
    cpu_vs_f64 = worst(cpu["sd"], f64, params, base)
    readings = {}
    for name in ("card_f32", "card_tf32"):
        r = runs[name]
        upd, par, bn = (worst(r["sd"], cpu["sd"], params, base), worst(r["sd"], cpu["sd"], params),
                        worst(r["sd"], cpu["sd"], stats))
        vs_f64 = worst(r["sd"], f64, params, base)
        readings[name] = {
            "items_card": r["items"].tolist(), "items_cpu": cpu["items"].tolist(),
            "items_cpu64": runs["cpu64"]["items"].tolist(),
            "loss_rel": abs(r["items"][0] - cpu["items"][0]).item() / abs(cpu["items"][0]).item(),
            "update_rel": upd[0][0], "worst_updates": upd[:3], "param_rel": par[0][0],
            "bn_stat_rel": bn[0][0], "worst_bn_stats": bn[:3],
            "update_rel_vs_f64": vs_f64[0][0], "cpu_update_rel_vs_f64": cpu_vs_f64[0][0],
            "worst_updates_vs_f64": vs_f64[:3], "not_moved_in_float64": unmoved}
    limits = {"loss_rel": SEM_STEP_LOSS_TOL, "update_rel": SEM_STEP_UPDATE_TOL,
              "bn_stat_rel": SEM_STEP_BN_TOL}
    if earned:
        limits["update_rel"] = 2 * cpu_vs_f64[0][0] + 1e-3
    for name, r in readings.items():
        r["within"] = {k: (lim is not None and r[k] <= lim) for k, lim in limits.items()}
        r["limits"] = limits
        print(f"semantic train step card vs cpu ({cfg}, {name}, bs {SEM_STEP_FRAMES}, "
              f"{SEM_STEP_SIZE} px): " + json.dumps(r), flush=True)
    off, on = readings["card_f32"], readings["card_tf32"]
    if all(v is not None for v in limits.values()):
        if not all(off["within"].values()):
            raise AssertionError(f"semantic train step card vs CPU beyond {limits}: {off}")
        if not off["update_rel_vs_f64"] <= 2 * off["cpu_update_rel_vs_f64"] + 1e-3:
            raise AssertionError(f"semantic train step: the card's float32 updates stand further "
                                 f"from float64 than twice the CPU's: {off}")
        if not earned and any(on["within"].values()):
            raise AssertionError(f"semantic train step: TF32 convolutions pass a limit of "
                                 f"{limits}, which then does not tell float32 from TF32: {on}")
    if not np.isfinite(off["items_card"]).all():
        raise AssertionError(f"semantic train step: loss items {off['items_card']}")
    return readings


def semantic_micro_steps(samples, card: str, cfg: str = "resnet50.json") -> dict:
    """The CLI's micro-step at full width on device-route batches already on
    the card: 4 warm-up micro-steps, 8 split by CUDA events into forward +
    loss / backward / optimizer + EMA, 8 whole; the parameters move on every
    SEM_ACCUMULATE-th only; peak memory; for a model with DCNv2 blocks their
    share of the forward and the backward (dcnv2_share)."""
    from yolo_dual_tpu_torch.kernels.preprocess import semantic_preprocess
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    model = SemanticSegModel(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    trainer, state = semantic_train_setup(model, SEM_BS, SEM_ACCUMULATE,
                                          steps_per_epoch=SEM_TRAIN_FRAMES // SEM_BS)
    batches = []
    for s in range(0, 2 * SEM_BS, SEM_BS):
        chunk = samples[s:s + SEM_BS]
        image, mask = semantic_preprocess(
            torch.from_numpy(np.stack([c["image_raw"] for c in chunk])).cuda(),
            torch.from_numpy(np.stack([c["mask_raw"] for c in chunk])).cuda(), 640,
            flip=torch.tensor([c["flip"] for c in chunk]).cuda(),
            bright=torch.tensor([c["bright"] for c in chunk]).cuda(),
            contr=torch.tensor([c["contr"] for c in chunk]).cuda())
        batches.append({"image": image, "mask": mask})
    params = list(model.parameters())
    flat = lambda: torch.cat([p.detach().flatten() for p in params])  # noqa: E731
    moved = []
    for i in range(2 * SEM_ACCUMULATE):
        before = flat()
        state, metrics = trainer.train_step(state, batches[i % 2])
        moved.append(not torch.equal(before, flat()))
    boundaries = [(i + 1) % SEM_ACCUMULATE == 0 for i in range(2 * SEM_ACCUMULATE)]
    if moved != boundaries or state.ema.updates != 2 or not torch.isfinite(metrics["items"]).all():
        raise AssertionError(f"semantic micro-steps: moved {moved}, expected {boundaries}; EMA "
                             f"updates {state.ema.updates}; items {metrics['items'].tolist()}")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    split = []
    for i in range(8):
        e = [ev() for _ in range(4)]
        model.zero_grad(set_to_none=True)
        e[0].record()
        loss, _ = trainer.forward_loss(model, batches[i % 2])
        e[1].record()
        loss.backward()
        e[2].record()
        trainer.apply_gradients(state)
        e[3].record()
        split.append(e)
    torch.cuda.synchronize()
    parts = np.array([[a.elapsed_time(b) for a, b in zip(e, e[1:])] for e in split])
    torch.cuda.reset_peak_memory_stats()
    whole = cuda_ms(lambda: trainer.train_step(state, batches[0]), 8, warmup=0)
    real = [i for i in range(8) if (i + 1) % SEM_ACCUMULATE == 0]
    out = {"model": cfg.removesuffix(".json"), "card": card, "bs": SEM_BS, "imgsz": 640,
           "accumulate": SEM_ACCUMULATE, "tf32": {"cudnn_conv": True, "matmul": False},
           "micro_step_ms": whole, "img_per_s": SEM_BS / (whole / 1e3),
           "forward_loss_ms": float(parts[:, 0].mean()), "backward_ms": float(parts[:, 1].mean()),
           "optimizer_ema_ms": float(parts[:, 2].mean()),
           "optimizer_ema_ms_on_real_steps": float(parts[real, 2].mean()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    share = dcnv2_share(model, batches[0]["image"], out)
    if share:
        out["dcnv2_share"] = share
    print("semantic train timing " + json.dumps(out), flush=True)
    del model, trainer, state, batches
    torch.cuda.empty_cache()
    return out


def semantic_host_batch_ms(img_dir: Path, json_dir: Path) -> dict:
    """One bs-16 training batch built on this thread, each route with its
    augmentation (the loader's work: reads, and on the host route
    _augment_pair and the resize and pad)."""
    from yolo_dual_tpu_torch.data.json_dataset import JSONSegmentDataset
    out = {}
    for route, dp in (("host", False), ("device", True)):
        ds = JSONSegmentDataset(img_dir, json_dir, 640, augment=True, seed=5,
                                device_preprocess=dp)
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(SEM_BS)]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        out[route] = (time.perf_counter() - t0) * 1e3
        del batch
    return out


def semantic_train_path(card: str):
    """Phase 6d: the semantic flagship's training. (a) one step card against
    CPU; the micro-step timed; (b) `semantic.train` in-process with
    resnet50.json at full width on a CamVid-style set written under build/:
    SEM_TRAIN_EPOCHS epochs on the device route (K1 once a training batch, the
    count set to 0 just before), a bare --resume to one more, one host-route
    epoch (0 launches), the native mask scanner loaded, results.csv finite;
    (c) the learning proof. Returns the K1 launches by geometry and a function
    that profiles one more resumed device-route epoch (after phase 9)."""
    import shutil
    from yolo_dual_tpu_torch import native
    from yolo_dual_tpu_torch.data.json_dataset import JSONSegmentDataset
    from yolo_dual_tpu_torch.data.tools import write_synthetic_camvid_scene
    from yolo_dual_tpu_torch.semantic import train as cli
    root = Path(__file__).resolve().parent / "build" / "phase6d"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    img_dir, json_dir = write_semantic_set(root / "train", SEM_TRAIN_FRAMES, seed=41)
    val_img, val_json = write_semantic_set(root / "val", SEM_VAL_FRAMES, seed=42)
    write_s = time.perf_counter() - t
    ds = JSONSegmentDataset(img_dir, json_dir, 640, augment=True, seed=0, device_preprocess=True)
    samples = [ds[i] for i in range(2 * SEM_BS)]
    result = {"card": card, "frames": {"train": SEM_TRAIN_FRAMES, "val": SEM_VAL_FRAMES},
              "write_dataset_s": write_s}
    result["step_card_vs_cpu"] = semantic_step_card_vs_cpu(
        [s["image_raw"] for s in samples[:4]], [s["mask_raw"] for s in samples[:4]])
    result["micro_step"] = semantic_micro_steps(samples, card)
    del samples
    result["host_batch_ms"] = semantic_host_batch_ms(img_dir, json_dir)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    project = root / "runs"
    common = ["--cfg", "resnet50.json", "--img-dir", str(img_dir), "--json-dir", str(json_dir),
              "--val-img-dir", str(val_img), "--val-json-dir", str(val_json),
              "--project", str(project), "--device", "cuda"]
    steps = SEM_TRAIN_FRAMES // SEM_BS
    probe = CliProbe(cli)
    try:
        torch.cuda.reset_peak_memory_stats()
        (dev_epochs, _), dev_launches = cli_launches(lambda: probe.run(
            common + ["--epochs", str(SEM_TRAIN_EPOCHS), "--name", "device",
                      "--device-preprocess"]))
        peak = torch.cuda.max_memory_allocated()
        dev_res = cli_results(project / "device")
        (_, _), resume_launches = cli_launches(lambda: probe.run(
            ["--project", str(project), "--name", "device", "--resume", "--epochs",
             str(SEM_TRAIN_EPOCHS + 1), "--device", "cuda"]))
        resumed = cli_results(project / "device")
        (host_epochs, _), host_launches = cli_launches(lambda: probe.run(
            common + ["--epochs", "1", "--name", "host"]))
        host_res = cli_results(project / "host")
        scene = write_synthetic_camvid_scene(root / "scene")
        golden = learning_proof(probe, scene, root, project, "resnet50.json", "golden")
    finally:
        probe.close()
    native_loaded = native.load() is not None
    train_s = dev_epochs[-1]["train_s"]  # the second epoch: warm
    result.update({
        "native_scanner_loaded": native_loaded, "cli_peak_memory_gb": peak / 1e9,
        "device_route": {"epochs": dev_epochs, "epoch_img_per_s": SEM_TRAIN_FRAMES / train_s,
                         "launches": dev_launches, "results": dev_res.tolist()},
        "resumed": {"launches": resume_launches, "results": resumed.tolist()},
        "host_route": {"epochs": host_epochs,
                       "epoch_img_per_s": SEM_TRAIN_FRAMES / host_epochs[0]["train_s"],
                       "launches": host_launches, "results": host_res.tolist()},
        "golden": {**golden, "floor": SEM_GOLDEN_FLOOR}})
    print("semantic train " + json.dumps(result), flush=True)
    problems = []
    k1 = lambda n: {"letterbox_normalize": n, "dcnv3_sampling": 0,  # noqa: E731
                    "dcnv3_sampling_backward": 0}
    for got, w in ((dev_launches, k1(SEM_TRAIN_EPOCHS * steps)), (resume_launches, k1(steps)),
                   (host_launches, k1(0)), (golden["launches"], k1(GOLDEN_EPOCHS * 6))):
        if got != w:
            problems.append(f"launches {got}, expected {w}")
    if not native_loaded:
        problems.append("the native mask scanner did not load")
    if dev_res.shape != (SEM_TRAIN_EPOCHS, 7) or not np.isfinite(dev_res).all():
        problems.append(f"results.csv of the device route: {dev_res.tolist()}")
    if resumed[:, 0].tolist() != list(range(SEM_TRAIN_EPOCHS + 1)) or not np.isfinite(resumed).all():
        problems.append(f"results.csv after --resume: {resumed.tolist()}")
    if host_res.shape != (1, 7) or not np.isfinite(host_res).all():
        problems.append(f"results.csv of the host route: {host_res.tolist()}")
    if not golden["best_miou"] >= SEM_GOLDEN_FLOOR:
        problems.append(f"the learning proof reached mIoU {golden['best_miou']}, under the floor "
                        f"{SEM_GOLDEN_FLOOR}")
    if problems:
        raise AssertionError("semantic train: " + "; ".join(problems))
    launches = {"semantic_720x960_bs16_fill128": (SEM_TRAIN_EPOCHS + 1) * steps,
                "semantic_train_96_bs4_fill128": GOLDEN_EPOCHS * 6}

    def profile():
        """One more resumed device-route epoch under torch.profiler: the
        card's busy share of the epoch's wall clock (the loader, the steps,
        the val pass and the checkpoint writes)."""
        from torch.profiler import ProfilerActivity, profile as torch_profile
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                cli.main(["--project", str(project), "--name", "device", "--resume", "--epochs",
                          str(SEM_TRAIN_EPOCHS + 2), "--device", "cuda"])
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            epochs_run = cli_results(project / "device")[:, 0].tolist()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        if epochs_run != list(range(SEM_TRAIN_EPOCHS + 2)):
            raise AssertionError(f"the profiled --resume ran epochs {epochs_run}")
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        return {"card": card, "epoch_wall_ms_profiled": wall_ms,
                "device_ms": device_ms if device_ms else "not measured",
                "busy_share": device_ms / wall_ms if device_ms else "not measured",
                "idle_share": 1 - device_ms / wall_ms if device_ms else "not measured",
                "top_ms": [[e.key[:80], round(e.self_device_time_total / 1e3, 3), e.count]
                           for e in top]}
    return launches, profile


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """torch.use_deterministic_algorithms(on) (strict: an op without a
    deterministic variant raises) and cuDNN's deterministic algorithms, the
    earlier settings restored after."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = on, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


def learning_proof(probe, scene, root: Path, project: Path, cfg: str, name: str,
                   deterministic: bool = True) -> dict:
    """The controlled golden of tests/test_semantic_golden.py:122-135 through
    semantic.train on the device route (K1 at 96 -> 96): `cfg` on the
    synthetic scene `scene` (24 frames of 96 px), GOLDEN_EPOCHS epochs, bs 4,
    --nbs 4 --no-ema --no-augment, SEM_GOLDEN_HYP, the dice loss, seed 3.
    The run uses deterministic algorithms, as JAX's golden run was
    deterministic: with atomics (cuDNN's, the resize backward's, the
    scatter-adds') the 30 epochs are chaotic, and an H100 run of resnet50.json
    ended on a plateau at 0.457 where others reached 0.92 (PERF.md §6;
    `--proof-spread`). Returns each epoch's mIoU, the best, the run's seconds,
    the launches and a digest of last.pt's tensors."""
    import hashlib
    from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint
    hyp = root / "hyp_golden.json"
    hyp.write_text(json.dumps(SEM_GOLDEN_HYP))
    t = time.perf_counter()
    with deterministic_algorithms(deterministic):
        _, launches = cli_launches(lambda: probe.run(
            ["--cfg", cfg, "--img-dir", str(scene[0]), "--json-dir", str(scene[1]),
             "--imgsz", "96", "--batch-size", "4", "--epochs", str(GOLDEN_EPOCHS), "--hyp",
             str(hyp), "--loss", "dice", "--project", str(project), "--name", name, "--seed", "3",
             "--nbs", "4", "--no-ema", "--no-augment", "--device-preprocess", "--device",
             "cuda"]))
    run_s = time.perf_counter() - t
    res = cli_results(project / name)
    digest = hashlib.sha1()
    state = load_checkpoint(project / name / "last.pt")["model"]
    for k in sorted(state):
        digest.update(k.encode() + state[k].numpy().tobytes())
    return {"cfg": cfg, "deterministic": deterministic, "miou": res[:, 4].tolist(),
            "best_miou": float(res[:, 4].max()), "run_s": run_s, "launches": launches,
            "last_pt_sha1": digest.hexdigest()}


def proof_spread(runs: int) -> list:
    """Each learning proof (resnet50.json and YOLO_SEM_CFGS) `runs` times with
    deterministic algorithms and `runs` times without, in one process: the
    best mIoU, the runs' seconds and last.pt's digest of each. Deterministic
    runs of a config must give one digest."""
    import shutil
    from yolo_dual_tpu_torch.data.tools import write_synthetic_camvid_scene
    from yolo_dual_tpu_torch.semantic import train as cli
    root = Path(__file__).resolve().parent / "build" / "proof_spread"
    shutil.rmtree(root, ignore_errors=True)
    scene = write_synthetic_camvid_scene(root / "scene")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    floors = {"resnet50.json": SEM_GOLDEN_FLOOR,
              **{c: g - 0.05 for c, g in YOLO_SEM_GOLDEN.items()}}
    out, probe = [], CliProbe(cli)
    try:
        for cfg in floors:
            for det in (True, False):
                for i in range(runs):
                    p = learning_proof(probe, scene, root, root / "runs", cfg,
                                       f"{cfg.split('.')[0]}_{int(det)}_{i}", deterministic=det)
                    p["floor"] = floors[cfg]
                    print("proof spread " + json.dumps(p), flush=True)
                    out.append(p)
    finally:
        probe.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


# Phase 6e: the YOLO semantic family through the same CLIs and K1 as 6c and 6d, nc 12, 640 px,
# float32 with TF32 convolutions, full width and depth: yolov5_seg (18 DCNv2 calls in its three
# C3_DCN rows), yolov8_seg (C2f, three C2f_DCN) and yolov9_seg (five C3k2, GAM).
YOLO_SEM_CFGS = ("yolov5_seg.json", "yolov8_seg.json", "yolov9_seg.json")
# the controlled goldens of tests/test_semantic_golden.py:54-63, slack 0.05
YOLO_SEM_GOLDEN = {"yolov5_seg.json": 0.2830, "yolov8_seg.json": 0.3510,
                   "yolov9_seg.json": 0.3148}
YOLO_PREDICT_FRAMES = 4
# the smoke models' DCNv2 offset heads (conv_offset_mask, zero in JAX's init): biases
# N(0, (DCN_OFFSET_BIAS_PX px)^2) on the offsets and N(0, 1) on the mask logits, weights
# N(0, gain^2 / fan_in). Offsets that follow the features steeply make a calibrated random
# network chaotic (tests/test_torch_port_semantic_yolo.py:spread_offsets): at gain 1 the
# narrow yolov5_seg's float32 forward stands ~0.8 from float64, at 0.1 3e-5
DCN2_OFFSET_GAIN = 0.1


def draw_dcnv2_heads(model, generator):
    """Seeded DCNv2 offset and mask heads, so samples leave the grid points
    (see DCN2_OFFSET_GAIN)."""
    from yolo_dual_tpu_torch.nn.dcn import DCNv2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCNv2):
                head = m.conv_offset_mask
                w = torch.randn(head.weight.shape, generator=generator)
                head.weight.copy_(w * DCN2_OFFSET_GAIN / math.sqrt(head.weight[0].numel()))
                b = torch.randn(head.bias.shape, generator=generator)
                b[:2 * m.deformable_groups * m.k * m.k] *= DCN_OFFSET_BIAS_PX
                head.bias.copy_(b)
    return model


def dcnv2_share(model, x, step: dict) -> dict:
    """The DCNv2 blocks of `model` (train mode) on the inputs they get from the
    batch `x`, each timed alone by CUDA events: the block's forward, its
    backward (forward + backward less forward), and within it
    deform_conv2d_v2's; their sums over the micro-step's forward + loss and
    backward (`step`). {} for a model without DCNv2."""
    from yolo_dual_tpu_torch.nn import dcn
    mods = [m for m in model.modules() if isinstance(m, dcn.DCNv2)]
    if not mods:
        return {}
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a: inputs.__setitem__(mod, a[0].detach()))
             for m in mods]
    try:
        with torch.no_grad():
            model.train()(x)
    finally:
        for h in hooks:
            h.remove()
    orig = dcn.deform_conv2d_v2
    totals = dict.fromkeys(("block_fwd", "block_bwd", "deform_fwd", "deform_bwd"), 0.0)
    for m in mods:
        xi = inputs[m].requires_grad_(True)
        calls = []
        dcn.deform_conv2d_v2 = lambda *a: calls.append(a) or orig(*a)
        try:
            g = torch.randn_like(m(xi))
        finally:
            dcn.deform_conv2d_v2 = orig
        leaves = [xi, *m.parameters()]
        fwd = cuda_ms(lambda: m(xi), 5)
        totals["block_fwd"] += fwd
        totals["block_bwd"] += cuda_ms(lambda: torch.autograd.grad(m(xi), leaves, g), 5) - fwd
        ins = [t.detach().clone().requires_grad_(True) for t in calls[0][:5]]
        conf = calls[0][5:]
        gd = torch.randn_like(orig(*ins, *conf))
        fwd = cuda_ms(lambda: orig(*ins, *conf), 5)
        totals["deform_fwd"] += fwd
        totals["deform_bwd"] += cuda_ms(lambda: torch.autograd.grad(orig(*ins, *conf), ins, gd),
                                        5) - fwd
    del inputs
    out = {"calls": len(mods), **{k + "_ms": v for k, v in totals.items()},
           "block_share_of_forward_loss": totals["block_fwd"] / step["forward_loss_ms"],
           "block_share_of_backward": totals["block_bwd"] / step["backward_ms"],
           "deform_share_of_forward_loss": totals["deform_fwd"] / step["forward_loss_ms"],
           "deform_share_of_backward": totals["deform_bwd"] / step["backward_ms"]}
    out["block_share_of_micro_step"] = (totals["block_fwd"] + totals["block_bwd"]) \
        / step["micro_step_ms"]
    return out


def yolo_semantic_path(card: str):
    """Phase 6e: the YOLO semantic family, each config of YOLO_SEM_CFGS at full
    width and depth (seeded weights, DCNv2 offset heads drawn, BatchNorm
    calibrated on 4 frames at fill 128) on a CamVid-style set written under
    build/ (6c's writer: 48 train + 16 val 720x960 frames). (a) `semantic.val.run`
    at bs 16 on the device route over the 48 frames (the K1 count set to 0 just
    before reads 3), its speed line and img/s; 4 frames card against CPU under
    6c's limits (TF32 read, not required to break them); `semantic.predict.run`
    on YOLO_PREDICT_FRAMES frames at batch 1; the fused forward + argmax at bs 32.
    (b) the micro-step at bs 16, accumulate 4 on device-route batches, with its
    peak memory and the DCNv2 blocks' share; one train step card against CPU
    at 320 px with limits earned from a float64 run. (c) `semantic.train`: one
    device-route epoch (K1 3; results.csv finite; last.pt loads strict); for
    yolov5_seg a bare --resume to a second epoch, against an uninterrupted
    2-epoch run within a tolerance (its scatter-adds use atomics: two card
    runs are not bit-identical). (d) the learning proof of each config
    (`learning_proof`) at or above its golden less 0.05. Returns the K1
    launches by geometry and by path."""
    import shutil
    from yolo_dual_tpu_torch.data.json_dataset import JSONSegmentDataset
    from yolo_dual_tpu_torch.data.tools import write_synthetic_camvid_scene
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    from yolo_dual_tpu_torch.semantic import predict, val
    from yolo_dual_tpu_torch.semantic import train as cli
    from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint
    root = Path(__file__).resolve().parent / "build" / "phase6e"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    img_dir, json_dir = write_semantic_set(root / "train", SEM_TRAIN_FRAMES, seed=41)
    val_img, val_json = write_semantic_set(root / "val", SEM_VAL_FRAMES, seed=42)
    scene = write_synthetic_camvid_scene(root / "scene")
    ds = JSONSegmentDataset(img_dir, json_dir, 640, augment=True, seed=0, device_preprocess=True)
    samples = [ds[i] for i in range(2 * SEM_BS)]
    frames4 = [s["image_raw"] for s in samples[:SEM_CHECK_FRAMES]]
    masks4 = [s["mask_raw"] for s in samples[:SEM_CHECK_FRAMES]]
    for n in ("warm", "predict"):
        (root / n).mkdir()
    for i, f in enumerate(sorted(img_dir.iterdir())[:2 + YOLO_PREDICT_FRAMES]):
        shutil.copy(f, root / ("warm" if i < 2 else "predict") / f.name)
    out = {"card": card, "set_up_s": time.perf_counter() - t}
    project = root / "runs"
    steps = SEM_TRAIN_FRAMES // SEM_BS
    n_batches = -(-SEM_TRAIN_FRAMES // SEM_BS)
    k1 = {"val": 0, "train": 0, "proof": 0}
    problems = []
    probe = CliProbe(cli)

    def prepare(model):
        return draw_dcnv2_heads(model, torch.Generator().manual_seed(1))
    try:
        for cfg in YOLO_SEM_CFGS:
            name = cfg.removesuffix(".json")
            r = {}
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True
            # (a) serving and evaluation
            model = SemanticSegModel(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
            calibrate_bn(prepare(model), frames4, fill=128.0)
            weights = root / f"{name}-calibrated.pt"
            torch.save(model.state_dict(), weights)
            model.fuse()
            letterbox_normalize.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (miou, vloss, _, _), _, (ms,) = val.run(
                weights=str(weights), cfg=cfg, img_dir=str(img_dir), json_dir=str(json_dir),
                imgsz=640, batch_size=SEM_BS, nc=SEM_NC, device="cuda", device_preprocess=True)
            wall = time.perf_counter() - t0
            r["val"] = {"miou": float(miou), "val_loss": float(vloss), "speed_ms_per_image": ms,
                        "img_per_s_timed": 1e3 / ms, "img_per_s_run": SEM_TRAIN_FRAMES / wall,
                        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "k1_launches": letterbox_normalize.launches}
            k1["val"] += letterbox_normalize.launches
            print(f"semantic val {name} (device route): speed {ms:.3f} ms an image, "
                  f"{SEM_TRAIN_FRAMES / wall:.1f} img/s a whole run, mIoU {miou:.4f}", flush=True)
            if r["val"]["k1_launches"] != n_batches or not (np.isfinite(vloss) and 0 <= miou <= 1):
                problems.append(f"{name} val: {r['val']}")
            r["card_vs_cpu"] = semantic_card_vs_cpu(model, frames4, masks4, tf32_must_break=False)
            predict.run(weights=str(weights), cfg=cfg, source=str(root / "warm"),
                        project=str(root), name=f"{name}_p0", device="cuda")
            metrics, out_dir, speed = predict.run(
                weights=str(weights), cfg=cfg, source=str(root / "predict"),
                gt_json_dir=str(json_dir), project=str(root), name=f"{name}_p1", device="cuda")
            if len(list(out_dir.iterdir())) != 3 * YOLO_PREDICT_FRAMES \
                    or not np.isfinite(metrics["mIoU"]):
                problems.append(f"{name} predict: {metrics}")
            r["predict_bs1_ms_per_frame"] = dict(zip(("pre", "infer", "post"), speed))
            x = torch.rand(SEM_INFER_BS, 3, 640, 640, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4))
            with torch.inference_mode():
                fms = cuda_ms(lambda: model(x).argmax(1), 10)
            r["fused_forward_argmax_bs32"] = {"ms": fms, "img_per_s": SEM_INFER_BS / fms * 1e3}
            del model, x
            torch.cuda.empty_cache()
            # (b) the micro-step, and one step card against CPU
            r["micro_step"] = semantic_micro_steps(samples, card, cfg)
            r["step_card_vs_cpu"] = semantic_step_card_vs_cpu(frames4, masks4, cfg, earned=True,
                                                              prepare=prepare)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True
            # (c) semantic.train: one device-route epoch
            common = ["--cfg", cfg, "--img-dir", str(img_dir), "--json-dir", str(json_dir),
                      "--val-img-dir", str(val_img), "--val-json-dir", str(val_json),
                      "--project", str(project), "--device", "cuda", "--device-preprocess"]
            (epochs, _), launches = cli_launches(lambda: probe.run(
                common + ["--epochs", "1", "--name", name]))
            res = cli_results(project / name)
            last = load_checkpoint(project / name / "last.pt")
            SemanticSegModel(cfg, device="cuda").load_state_dict(last["model"], strict=True)
            r["cli_epoch"] = {"epochs": epochs, "launches": launches, "results": res.tolist(),
                              "epoch_img_per_s": SEM_TRAIN_FRAMES / epochs[0]["train_s"]}
            k1["train"] += launches["letterbox_normalize"]
            if launches["letterbox_normalize"] != steps or res.shape != (1, 7) \
                    or not np.isfinite(res).all():
                problems.append(f"{name} train epoch: {r['cli_epoch']}")
            if name == "yolov5_seg":
                (_, _), rl = cli_launches(lambda: probe.run(
                    ["--project", str(project), "--name", name, "--resume", "--epochs", "2",
                     "--device", "cuda"]))
                (_, _), ul = cli_launches(lambda: probe.run(
                    common + ["--epochs", "2", "--name", f"{name}_2ep"]))
                a, b = cli_results(project / name), cli_results(project / f"{name}_2ep")
                rel = lambda c: float(np.abs(a[:, c] - b[:, c]).max() / np.abs(b[:, c]).max())  # noqa: E731
                gap = {"loss_rel": rel(slice(1, 4)), "val_loss_rel": rel(5),
                       "miou_abs": float(np.abs(a[:, [4, 6]] - b[:, [4, 6]]).max())}
                r["resume_vs_uninterrupted"] = {"resumed": a.tolist(), "uninterrupted": b.tolist(),
                                                "gap": gap, "limits": RESUME_TOL}
                k1["train"] += rl["letterbox_normalize"] + ul["letterbox_normalize"]
                if a[:, 0].tolist() != [0, 1] or rl["letterbox_normalize"] != steps \
                        or ul["letterbox_normalize"] != 2 * steps \
                        or any(gap[k] > RESUME_TOL[k] for k in gap):
                    problems.append(f"{name} --resume: {r['resume_vs_uninterrupted']}")
            # (d) the learning proof
            proof = learning_proof(probe, scene, root, project, cfg, f"{name}_golden")
            proof["floor"] = YOLO_SEM_GOLDEN[cfg] - 0.05
            r["learning_proof"] = proof
            k1["proof"] += proof["launches"]["letterbox_normalize"]
            if proof["launches"]["letterbox_normalize"] != GOLDEN_EPOCHS * 6 \
                    or not proof["best_miou"] >= proof["floor"]:
                problems.append(f"{name} learning proof: best mIoU {proof['best_miou']}, floor "
                                f"{proof['floor']}, launches {proof['launches']}")
            out[name] = r
            print(f"semantic yolo {name} " + json.dumps(r), flush=True)
    finally:
        probe.close()
        shutil.rmtree(root, ignore_errors=True)
    print("semantic yolo " + json.dumps({k: out[k] for k in ("card", "set_up_s")}), flush=True)
    if problems:
        raise AssertionError("semantic yolo: " + "; ".join(problems))
    launches = {"semantic_720x960_bs16_fill128": k1["val"] + k1["train"],
                "semantic_train_96_bs4_fill128": k1["proof"]}
    return launches, {"eval": k1["val"], "train": k1["train"] + k1["proof"]}


# Phase 6f: the detect zoo through build_model (DetectionModel) and AutoShape, nc 80, 640 px,
# each config at its own published width and depth: the 17 configs of the SPP, attention, Ghost,
# Transformer and YOLOv3 modules, and yolov5s as the control.
DETECT_ZOO = ("yolov5s.json", "yolov5n-ASPP.json", "yolov5n-RFB.json", "yolov5n-SPP.json",
              "yolov5n-SPPCSPC.json", "yolov5n-SPPCSPC_group.json", "yolov5n-SimCSPSPPF.json",
              "yolov5n-SimSPPF.json", "yolov5n-FPN+PAN-AC.json", "yolov5n-FPN+PAN-AS.json",
              "yolov5n-FPN-AC.json", "yolov5n-FPN-AS.json", "yolov5n-PAN-AC.json",
              "yolov5n-PAN-AS.json", "yolov3-spp.json", "yolov3-tiny.json", "yolov5s-ghost.json",
              "yolov5s-transformer.json")
ZOO_CONF = 0.05  # checks and timed calls: a random network keeps few or no rows at 0.25
ZOO_CHECK_MAX_DET = 1000  # card vs CPU: no max_det cut
ZOO_RAW_TOL = 1e-3  # card vs CPU, TF32 off: raw head maps within this share of a map's largest
ZOO_BOX_TOL, ZOO_CONF_TOL, ZOO_NEAR = 0.05, 1e-4, 1e-4  # px; confidence; a near tie
ZOO_FRAMES, ZOO_BATCH = 4, 8


def detect_zoo_path(card: str) -> dict:
    """Phase 6f: each config of DETECT_ZOO built by `build_model` on the card
    (seeded weights with the bias prior, BatchNorm calibrated on 4 seeded
    frames: identity statistics make random scores tie) behind
    `AutoShape(fuse=True)` at 640 px and conf ZOO_CONF (a random network keeps
    few or no rows at AutoShape's default 0.25), on ZOO_FRAMES seeded frames
    of the MAIN_SHAPES sizes. Card against CPU with TF32 off: the raw head maps
    of the host-letterboxed frames within ZOO_RAW_TOL of each map's largest
    magnitude, and AutoShape's detections paired (tests/detection_matching.py:
    the same classes, boxes within ZOO_BOX_TOL px, confidences within
    ZOO_CONF_TOL; near ties counted and printed, not compared). Timed with
    TF32 convolutions (torch's default), each beside the rows its last call
    returned: the bs-32 fused forward + nms_from_raw over the letterboxed
    frames in img/s (CUDA events) and its peak memory; AutoShape at batch 1
    on each frame and at ZOO_BATCH, ms a call split into host letterbox /
    forward + NMS / rescale (host clock). Every config's
    failure fails the phase. The
    path launches none of K1-K3 (AutoShape letterboxes on the host): the
    counts, set to 0 before each config's AutoShape calls and read after them,
    are returned. Every config runs at nc 80 (the spp/ and attention/ files
    say 2)."""
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.engine.autoshape import AutoShape
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import build_model
    from detection_matching import pair_detections
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    kernels = (letterbox_normalize, dcnv3_sampling, dcnv3_sampling_backward)
    print(f"detect zoo (6f) on {card}: {len(DETECT_ZOO)} configs, nc 80, 640 px, conf {ZOO_CONF}",
          flush=True)
    frames = make_frames(ZOO_FRAMES, seed=5)
    calib = make_frames(4, seed=6)
    x = torch.from_numpy(np.stack([letterbox(f, 640)[0] for f in frames])).permute(0, 3, 1, 2)
    x32 = x.repeat(32 // len(frames), 1, 1, 1).cuda().float() / 255
    launches = {k.__name__: 0 for k in kernels}
    failures = []
    for cfg in DETECT_ZOO:
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        model = build_model(cfg, nc=80, device="cuda", generator=torch.Generator().manual_seed(0))
        assert type(model).__name__ == "DetectionModel" and model.nc == 80, cfg
        calibrate_bn(model, calib)
        api = AutoShape(model, imgsz=640, conf=ZOO_CONF)
        head = model.model[-1]
        row = {"cfg": cfg, "params": sum(p.numel() for p in model.parameters()),
               "strides": list(head.strides), "build_s": time.perf_counter() - t0}

        # card against CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        cpu_model = copy.deepcopy(model).cpu()
        with torch.inference_mode():
            raw_g = model(x.cuda().float() / 255, decode=False)
            raw_c = cpu_model(x.float() / 255, decode=False)
        raw = [((g.cpu() - c).abs().max() / c.abs().max()).item() for g, c in zip(raw_g, raw_c)]
        for k in kernels:
            k.launches = 0
        check = dict(imgsz=640, conf=ZOO_CONF, max_det=ZOO_CHECK_MAX_DET)
        got = AutoShape(model, **check)(frames)
        want = AutoShape(cpu_model, **check)(frames)
        pairs = ties = 0
        left = []
        for w, g in zip(want.dets, got.dets):
            n, t, lw, lg = pair_detections(w, g, ZOO_CONF, box_tol=ZOO_BOX_TOL,
                                           conf_tol=ZOO_CONF_TOL, near=ZOO_NEAR)
            pairs, ties = pairs + n, ties + t
            left += [r.tolist() for r in (*lw, *lg)]
        row["card_vs_cpu"] = {"raw_max_rel_diff": raw, "detections": [len(d) for d in got.dets],
                              "cpu_detections": [len(d) for d in want.dets], "pairs": pairs,
                              "near_ties": ties}
        if max(raw) > ZOO_RAW_TOL or left or not all(np.isfinite(d).all() for d in got.dets):
            failures.append(f"{cfg}: raw {raw}, unpaired rows {left[:4]}")
        del cpu_model

        # timing, TF32 convolutions
        torch.backends.cudnn.allow_tf32 = True

        def step():
            with torch.inference_mode():
                return nms_from_raw(model(x32, decode=False), head.anchors, head.strides,
                                    conf_thres=ZOO_CONF, max_det=300)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row["bs32_img_per_s"] = 32 / (cuda_ms(step, 10) / 1e3)
        row["bs32_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row["bs32_rows"] = int(step()[1].sum())

        def autoshape_ms(batch):
            api(batch)  # warm-up at this batch
            parts = np.zeros(3)
            for _ in range(3):
                out = api(batch)
                parts += np.array(out.t) * len(batch) / 3
            return {"letterbox": parts[0], "forward_nms": parts[1], "rescale": parts[2],
                    "call": float(parts.sum()), "rows": sum(len(d) for d in out.dets)}
        row["autoshape_bs1_ms"] = [{"frame": "x".join(map(str, f.shape[:2])), **autoshape_ms([f])}
                                   for f in frames]
        row[f"autoshape_bs{ZOO_BATCH}_ms"] = autoshape_ms(
            [frames[i % len(frames)] for i in range(ZOO_BATCH)])
        for k in kernels:
            launches[k.__name__] += k.launches
        row["phase_s"] = time.perf_counter() - t0
        print("detect zoo " + json.dumps(row), flush=True)
        del model, api, step, raw_g, raw_c
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("detect zoo card vs CPU: " + "; ".join(failures))
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
    return launches, calls, profile, whole


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


# Phase 10: the train CLI on a dataset on disk. Frames per split: (h, w) -> count
CLI_SETS = {"train": {(480, 640): 32, (720, 1280): 16, (360, 480): 16}, "val": {(480, 640): 32}}
CLI_EPOCHS, CLI_MAX_POLYGONS = 2, 8
# the first micro-step's loss, bf16 autocast against float32: at most 5e-3
# relative (measured 4.8e-4), and more than 10x what a float32 rerun moves it
CLI_BF16_LOSS_RTOL, CLI_BF16_OVER_RERUN = 5e-3, 10
MOSAIC_TOL = 1e-4  # mosaic_warp_hsv card against CPU, after /255


def write_train_set(root: Path) -> Path:
    """CLI_SETS as `.npy` frames under root/images/{train,val} with txt labels
    under root/labels/{train,val}: seeded noise frames, 1..CLI_MAX_POLYGONS
    hexagons a frame of 80 classes (normalised polygon rows), each over a
    bright box so an object has pixels of its own."""
    rng = np.random.default_rng(10)
    for split, shapes in CLI_SETS.items():
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for (h, w), n in shapes.items():
            for j in range(n):
                im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                lines = []
                for _ in range(int(rng.integers(1, CLI_MAX_POLYGONS + 1))):
                    c, r = rng.uniform(0.15, 0.85, 2), rng.uniform(0.03, 0.15)
                    ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
                    pts = np.clip(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1), 0, 1)
                    (x0, y0), (x1, y1) = ((pts.min(0) * [w, h]).astype(int),
                                          (pts.max(0) * [w, h]).astype(int))
                    im[y0:y1, x0:x1] = rng.integers(160, 256, 3)
                    lines.append(" ".join([str(rng.integers(0, 80))]
                                          + [f"{v:.6f}" for v in pts.reshape(-1)]))
                np.save(root / "images" / split / f"{h}x{w}_{j:03d}.npy", im)
                (root / "labels" / split / f"{h}x{w}_{j:03d}.txt").write_text("\n".join(lines))
    return root


class CliProbe(logging.Handler):
    """Runs a train CLI in-process (segment.train unless `cli` is given) and
    reads what it reports: each epoch's
    train, val and save seconds from the `epoch_times` of its log records, and,
    through one wrapper around Trainer.train_step, the loss items of the run's
    first micro-step."""

    def __init__(self, cli=None):
        super().__init__()
        from yolo_dual_tpu_torch.segment import train as segment_cli
        from yolo_dual_tpu_torch.train.trainer import Trainer
        from yolo_dual_tpu_torch.utils.general import LOGGER
        self.cli, self.logger, self.step = cli or segment_cli, LOGGER, Trainer.train_step
        self.epochs, self.first_items = [], None
        probe = self

        def train_step(trainer, state, batch):
            state, metrics = probe.step(trainer, state, batch)
            if probe.first_items is None:
                probe.first_items = [float(v) for v in metrics["items"].tolist()]
            return state, metrics
        Trainer.train_step = train_step
        LOGGER.addHandler(self)

    def emit(self, record):
        if hasattr(record, "epoch_times"):
            self.epochs.append(record.epoch_times)

    def run(self, args):
        self.epochs, self.first_items = [], None
        self.cli.main(args)
        return self.epochs, self.first_items

    def close(self):
        from yolo_dual_tpu_torch.train.trainer import Trainer
        Trainer.train_step = self.step
        self.logger.removeHandler(self)
        super().close()


def cli_launches(fn):
    """Run fn with the kernels' counts set to 0 just before; the counts after."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    torch.cuda.synchronize()
    letterbox_normalize.launches = dcnv3_sampling.launches = dcnv3_sampling_backward.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"letterbox_normalize": letterbox_normalize.launches,
                 "dcnv3_sampling": dcnv3_sampling.launches,
                 "dcnv3_sampling_backward": dcnv3_sampling_backward.launches}


def cli_results(run: Path) -> np.ndarray:
    rows = (run / "results.csv").read_text().strip().splitlines()[1:]
    return np.array([[float(v) for v in r.split(",")] for r in rows])


def loader_batch_phase(root: Path, card: str) -> dict:
    """One bs-16 training batch built in this thread, timed by part (tile
    loads and resizes, polygon rasterising, the rest: mosaic geometry, label
    warps, padding); its tiles' H2D copy, pinned and pageable; and
    mosaic_warp_hsv on it, card against CPU and timed."""
    from yolo_dual_tpu_torch.data import dataset as dsmod
    from yolo_dual_tpu_torch.kernels.augment import mosaic_warp_hsv
    from yolo_dual_tpu_torch.data.loader import to_device
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg("hyp.scratch-low.json"))
    loader, ds = dsmod.create_dataloader(str(root / "images" / "train"), TRAIN_IMGSZ, TRAIN_BS,
                                         hyp=hyp, augment=True, shuffle=True,
                                         mask_downsample_ratio=4, overlap_mask=True, seed=0,
                                         device_aug=True)
    spent = {"load_image": 0.0, "polygons2masks_overlap": 0.0}

    def timed(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t
        setattr(owner, name, wrapper)
        return owner, name, fn
    saved = [timed(dsmod.YoloDataset, "load_image"), timed(dsmod, "polygons2masks_overlap")]
    try:
        t0 = time.perf_counter()
        samples = [ds[i] for i in loader._indices()[:TRAIN_BS]]
        batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    keys = ("aug_tiles", "aug_dst", "aug_off", "aug_invm", "aug_hsv", "aug_flips")

    def h2d(pin):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = to_device(batch["aug_tiles"], torch.device("cuda"), pin)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, x
    pinned = [h2d(True)[0] for _ in range(3)]
    pageable = [h2d(False)[0] for _ in range(3)]
    args = [torch.from_numpy(batch[k]).cuda() for k in keys]
    card_out = mosaic_warp_hsv(*args, out_size=TRAIN_IMGSZ)
    warp_ms = cuda_ms(lambda: mosaic_warp_hsv(*args, out_size=TRAIN_IMGSZ), 10)
    t = time.perf_counter()
    cpu_out = mosaic_warp_hsv(*(torch.from_numpy(batch[k]) for k in keys), out_size=TRAIN_IMGSZ)
    cpu_ms = (time.perf_counter() - t) * 1e3
    err = (card_out.cpu() - cpu_out).abs()
    n_poly = int(batch["tmask"].sum())
    out = {"card": card, "bs": TRAIN_BS, "imgsz": TRAIN_IMGSZ, "host_batch_ms": host_ms,
           "of_it_load_image_ms": spent["load_image"] * 1e3,
           "of_it_rasterise_ms": spent["polygons2masks_overlap"] * 1e3,
           "instances_in_batch": n_poly, "tiles_mb": batch["aug_tiles"].nbytes / 1e6,
           "tiles_h2d_pinned_ms": pinned, "tiles_h2d_pageable_ms": pageable,
           "mosaic_warp_hsv_ms": warp_ms, "mosaic_warp_hsv_cpu_ms": cpu_ms,
           "mosaic_card_vs_cpu_max_abs_err": err.max().item(),
           "mosaic_share_above_1e-6": (err > 1e-6).float().mean().item()}
    print("train data " + json.dumps(out), flush=True)
    if out["mosaic_card_vs_cpu_max_abs_err"] > MOSAIC_TOL:
        raise AssertionError(f"mosaic_warp_hsv card against CPU: {out['mosaic_card_vs_cpu_max_abs_err']} "
                             f"> {MOSAIC_TOL}")
    return out


def cli_train_path(card: str, micro_step_ms: float):
    """Phase 10: the train CLI, yolov5s-seg-dcnv3 at 640 px, bs 16, on a
    dataset written under build/: 2 epochs in float32 (launches counted),
    a resumed third, a bf16 epoch, the loader's batch and mosaic_warp_hsv
    checked and timed. Returns the 2-epoch run's launches and a function that
    profiles one more resumed epoch."""
    import shutil
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = Path(__file__).resolve().parent / "build" / "phase10"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    write_train_set(root)
    write_s = time.perf_counter() - t
    project = root / "runs"
    common = ["--cfg", "yolov5s-seg-dcnv3.json", "--data", str(root), "--hyp",
              "hyp.scratch-low.json", "--imgsz", str(TRAIN_IMGSZ), "--batch-size", str(TRAIN_BS),
              "--project", str(project), "--noplots", "--device", "cuda"]
    n_train, n_val = (sum(CLI_SETS[k].values()) for k in ("train", "val"))
    steps, val_batches = -(-n_train // TRAIN_BS), -(-n_val // TRAIN_BS)
    n_dcn = sum(DCN_PATH_SHAPES.values())

    def want(epochs):
        return {"letterbox_normalize": 0, "dcnv3_sampling": n_dcn * epochs * (steps + val_batches),
                "dcnv3_sampling_backward": n_dcn * epochs * steps}
    probe = CliProbe()
    try:
        t = time.perf_counter()
        (epochs, items32), launches = cli_launches(lambda: probe.run(
            common + ["--epochs", str(CLI_EPOCHS), "--dtype", "f32", "--name", "f32"]))
        run_s = time.perf_counter() - t
        res = cli_results(project / "f32")
        for f in ("last.pt", "best.pt"):
            SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu").load_state_dict(
                load_state_dict_file(project / "f32" / f), strict=True)
        (_, _), resume_launches = cli_launches(lambda: probe.run(
            ["--project", str(project), "--name", "f32", "--resume", "--epochs",
             str(CLI_EPOCHS + 1)]))
        resumed = cli_results(project / "f32")
        (_, items16), bf16_launches = cli_launches(lambda: probe.run(
            common + ["--epochs", "1", "--dtype", "bf16", "--name", "bf16"]))
        bf16 = cli_results(project / "bf16")
        # a name outside the f32* runs that a bare --resume of "f32" chooses from
        _, items32_rerun = probe.run(common + ["--epochs", "1", "--dtype", "f32",
                                               "--name", "rerun"])
    finally:
        probe.close()
    train_s = epochs[-1]["train_s"]  # the second epoch: warm

    def loss_rel(items):
        return abs(sum(items) - sum(items32)) / abs(sum(items32))
    rel, rerun_rel = loss_rel(items16), loss_rel(items32_rerun)
    out = {"card": card, "model": "yolov5s-seg-dcnv3", "bs": TRAIN_BS, "imgsz": TRAIN_IMGSZ,
           "frames": {"train": n_train, "val": n_val}, "write_dataset_s": write_s,
           "run_s_2_epochs": run_s, "launches": launches, "resume_launches": resume_launches,
           "bf16_launches": bf16_launches,
           "epoch_train_s": train_s, "epoch_img_per_s": n_train / train_s,
           "epoch_s_with_val_and_checkpoints": [e["train_s"] + e["val_s"] + e["save_s"]
                                                for e in epochs],
           "val_pass_ms": [e["val_s"] * 1e3 for e in epochs],
           "checkpoint_writes_ms": [e["save_s"] * 1e3 for e in epochs],
           "checkpoint_mb": {f: (project / "f32" / f).stat().st_size / 1e6
                             for f in ("last.pt", "best.pt")},
           "micro_step_ms_phase7": micro_step_ms,
           "micro_steps_s_per_epoch_at_phase7_rate": steps * micro_step_ms / 1e3,
           "results_f32": res.tolist(), "results_after_resume": resumed.tolist(),
           "results_bf16": bf16.tolist(), "first_micro_step_items_f32": items32,
           "first_micro_step_items_f32_rerun": items32_rerun,
           "first_micro_step_items_bf16": items16, "bf16_vs_f32_loss_rel": rel,
           "f32_rerun_vs_f32_loss_rel": rerun_rel, "bf16_tolerance": CLI_BF16_LOSS_RTOL,
           "bf16_over_rerun_at_least": CLI_BF16_OVER_RERUN}
    print("train cli " + json.dumps(out), flush=True)
    problems = []
    if res.shape[0] != CLI_EPOCHS or not np.isfinite(res[:, 1:5]).all():
        problems.append(f"results.csv of the f32 run: {res.tolist()}")
    if resumed[:, 0].tolist() != list(range(CLI_EPOCHS + 1)) or not np.isfinite(resumed).all():
        problems.append(f"results.csv after --resume: {resumed[:, 0].tolist()}")
    if bf16.shape[0] != 1 or not np.isfinite(bf16[:, 1:5]).all() or rel > CLI_BF16_LOSS_RTOL:
        problems.append(f"bf16 epoch: {bf16.tolist()}, loss against f32 {rel}")
    if not rel > CLI_BF16_OVER_RERUN * rerun_rel or not rel > 0:
        problems.append(f"bf16 epoch: its first loss moved {rel} from float32's, a float32 "
                        f"rerun {rerun_rel}: the forward did not run in bfloat16")
    for got, w in ((launches, want(CLI_EPOCHS)), (resume_launches, want(1)),
                   (bf16_launches, want(1))):
        if got != w:
            problems.append(f"launches {got}, expected {w}")
    if problems:
        raise AssertionError("train cli: " + "; ".join(problems))
    loader_batch_phase(root, card)

    def profile():
        """One more resumed epoch under torch.profiler: the card's busy share
        of the epoch's wall clock (the host loader, the steps, the val pass
        and the checkpoint writes)."""
        from torch.profiler import ProfilerActivity, profile as torch_profile
        from yolo_dual_tpu_torch.segment import train as cli
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cli.main(["--project", str(project), "--name", "f32", "--resume", "--epochs",
                      str(CLI_EPOCHS + 2)])
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        epochs_run = cli_results(project / "f32")[:, 0].tolist()
        shutil.rmtree(root, ignore_errors=True)
        if epochs_run != list(range(CLI_EPOCHS + 2)):
            raise AssertionError(f"the profiled --resume ran the f32 run to epochs {epochs_run}")
        return {"card": card, "epoch_wall_ms_profiled": wall_ms,
                "device_ms": device_ms if device_ms else "not measured",
                "busy_share": device_ms / wall_ms if device_ms else "not measured",
                "idle_share": 1 - device_ms / wall_ms if device_ms else "not measured"}
    return launches, profile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-times", metavar="ROOT", nargs="?",
                    const=str(Path(__file__).resolve().parent),
                    help="only K1's phase 3 and K1's, K2's and K3's device times, of the "
                         "package under ROOT")
    ap.add_argument("--proof-spread", metavar="RUNS", type=int,
                    help="only the four learning proofs, each RUNS times with deterministic "
                         "algorithms and RUNS times without")
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
        print(f"K1's phase 3 and device times of the package under {root}", flush=True)
        shapes = [[b, *k] for b in (1, TRAIN_BS, 32) for k in DCN_PATH_SHAPES]
        device_phase(letterbox_phase(),
                     {"x".join(map(str, s)): {"shape": s} for s in shapes},
                     {"x".join(map(str, s)): {"shape": s} for s in shapes if s[0] == TRAIN_BS})
        return 0

    if args.proof_spread:
        load_library("letterbox")
        runs = proof_spread(args.proof_spread)
        digests = {}
        for r in runs:
            if r["deterministic"]:
                digests.setdefault(r["cfg"], set()).add(r["last_pt_sha1"])
        summary = {cfg: {"deterministic": [r["best_miou"] for r in runs
                                           if r["cfg"] == cfg and r["deterministic"]],
                         "default": [r["best_miou"] for r in runs
                                     if r["cfg"] == cfg and not r["deterministic"]],
                         "deterministic_digests": len(d)} for cfg, d in digests.items()}
        print(f"proof spread ({card}) " + json.dumps(summary), flush=True)
        return 0 if all(len(d) == 1 for d in digests.values()) else 1

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
    # 6b. the validation slice: segment.val at bs 32 through K1
    by_path["eval yolov5s-seg"], eval_batch = eval_path(card)
    # 6c. the semantic flagship: semantic.val on both routes (K1 on the device route),
    # semantic.predict
    by_path["eval semantic resnet50"], semantic_profile = semantic_path(card)
    # 6d. the semantic flagship trains: one step card vs CPU, semantic.train on both routes,
    # --resume, the learning proof
    semantic_train_k1, semantic_train_profile = semantic_train_path(card)
    by_path["train semantic resnet50"] = {"letterbox_normalize": sum(semantic_train_k1.values())}
    # 6e. the YOLO semantic family: semantic.val, .predict, .train, the learning proofs
    yolo_k1, yolo_paths = yolo_semantic_path(card)
    by_path["eval semantic yolo"] = {"letterbox_normalize": yolo_paths["eval"]}
    by_path["train semantic yolo"] = {"letterbox_normalize": yolo_paths["train"]}
    # 6f. the detect zoo through build_model and AutoShape (no kernel on its path)
    by_path["detect zoo"] = detect_zoo_path(card)
    by_path["train yolov5s-seg-dcnv3"], trained, train_profile, step_ms = train_path(card)
    train_card_vs_cpu()
    # 10. the train CLI on a dataset on disk
    by_path["train CLI yolov5s-seg-dcnv3"], cli_profile = cli_train_path(card, step_ms)

    # 9. the kernels' own device times, on seeded and on the trained model's DCNv3 inputs;
    # then phase 7's profiled accumulation cycle: after a session of CPU and CUDA activity
    # the later sessions of the process missed or doubled kernel records
    device_phase(lres, dres, bres)
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    eval_k1 = profiled_kernel_ms(lambda: letterbox_normalize(eval_batch, 640, scaleup=False),
                                 "letterbox", 20)
    print(f"device letterbox on the eval batch {list(eval_batch.shape)} (scaleup=False): "
          f"{eval_k1} ms a launch", flush=True)
    del eval_batch
    trained_inputs_phase(trained)
    del trained
    print("train profile " + json.dumps(train_profile()), flush=True)
    del train_profile
    print("train cli epoch profile " + json.dumps(cli_profile()), flush=True)
    del cli_profile
    print("semantic val profile " + json.dumps(semantic_profile()), flush=True)
    del semantic_profile
    print("semantic train epoch profile " + json.dumps(semantic_train_profile()), flush=True)
    del semantic_train_profile

    # 11. kernels line: times are means over the launches of the main paths, each
    # launch weighted by the shape it ran at
    def total(kernel):
        return sum(p.get(kernel, 0) for p in by_path.values())

    def wmean(res, weights, key):
        return float(sum(res[n][key] * k for n, k in weights.items()) / sum(weights.values()))
    lcalls = {n: len(MODELS) * [list(MAIN_SHAPES)[i % len(MAIN_SHAPES)]
                                for i in range(N_FRAMES)].count(n) for n in MAIN_SHAPES}
    lcalls["val_480p_bs32_no_scaleup"] = by_path["eval yolov5s-seg"]["letterbox_normalize"]
    lcalls["semantic_720x960_bs16_fill128"] = \
        by_path["eval semantic resnet50"]["letterbox_normalize"] \
        + semantic_train_k1["semantic_720x960_bs16_fill128"] \
        + yolo_k1["semantic_720x960_bs16_fill128"]
    lcalls["semantic_train_96_bs4_fill128"] = semantic_train_k1["semantic_train_96_bs4_fill128"] \
        + yolo_k1["semantic_train_96_bs4_fill128"]
    # K2: 16 frames at batch 1 (prediction), 8 micro-steps at bs 16 (training), and the
    # CLI's forwards at bs 16 (its micro-steps and val batches); K3: the micro-steps
    n_dcn = sum(DCN_PATH_SHAPES.values())
    cli_fwd = by_path["train CLI yolov5s-seg-dcnv3"]["dcnv3_sampling"] // n_dcn
    cli_bwd = by_path["train CLI yolov5s-seg-dcnv3"]["dcnv3_sampling_backward"] // n_dcn
    dcalls = {f"{b}x{h}x{w}x{c}": n * reps for (h, w, c), n in DCN_PATH_SHAPES.items()
              for b, reps in ((1, N_FRAMES), (TRAIN_BS, TRAIN_MICRO_STEPS + cli_fwd))}
    bcalls = {f"{TRAIN_BS}x{h}x{w}x{c}": n * (TRAIN_MICRO_STEPS + cli_bwd)
              for (h, w, c), n in DCN_PATH_SHAPES.items()}
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
