#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (yolo_dual_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
without a CUDA device it exits non-zero and prints no result. Phases, each of
which raises on failure:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/letterbox.cu from this checkout with nvcc;
3. kernel: the letterbox kernel against its plain torch version at the
   predictor's shapes (max abs error <= 1e-5), with its time, the plain
   version's, one library call's (F.interpolate + F.pad + /255, timed only)
   and the memory-bound time;
4. slice: yolov5s-seg (nc=80, 640 px, full width, seeded random weights with
   the bias prior, BatchNorm statistics calibrated on three seeded frames,
   conv+BN fused) predicts 16 in-memory frames of 1080p, 720p
   and 480p on cuda; every frame keeps detections and the letterbox kernel is
   launched once per frame;
5. card against CPU: two frames through the same model on the GPU and on the
   CPU, TF32 off: raw level maps and protos agree to rtol 1e-3, detections by
   the matching rule of tests/test_torch_port_predict.py;
6. timing: the streaming predictor's per-frame pre/infer/post ms, and the
   batched forward + nms_from_raw at bs 32, 640 px in img/s;
7. a JSON line of every kernel with its launches on the main path, then the
   JSON result line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 rate (NVIDIA data sheet)
CONF_LOW = 1e-6  # random weights give confidences ~1e-5: keep NMS and masks busy
MAIN_SHAPES = {"1080p": (1080, 1920), "720p": (720, 1280), "480p": (480, 640)}
N_FRAMES = 16


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


def kernel_phase():
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from yolo_dual_tpu_torch.engine.predictor import predict_images
    from yolo_dual_tpu_torch.kernels.build import library_path, load_library
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.ops.boxes import match_detections
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    load_library("letterbox")
    print(f"build: csrc/letterbox.cu -> {library_path('letterbox').name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel against its plain version
    kres = kernel_phase()

    # 4. slice: yolov5s-seg prediction on cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # torch's default for float32 convolutions
    model = SegmentationModel("yolov5s-seg.json", device="cuda",
                              generator=torch.Generator().manual_seed(0))
    calibrate_bn(model, make_frames(3, seed=1)).fuse()
    nm = model.model[-1].nm
    assert model.model[-1].npr == 128 and model.nc == 80
    frames = make_frames(N_FRAMES)
    predict_images(model, frames[:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                   device="cuda")  # warm-up: cuDNN plans, allocator, tap tables
    letterbox_normalize.launches = 0
    dets = predict_images(model, frames, imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cuda")
    launches = {"letterbox_normalize": letterbox_normalize.launches}
    dt = predict_images.profiles
    assert len(dets) == N_FRAMES
    for i, d in enumerate(dets):
        if not (0 < len(d) <= 300 and d.shape[1] == 6 + nm and np.isfinite(d).all()):
            raise AssertionError(f"frame {i}: detections shape {d.shape}, finite {np.isfinite(d).all()}")
    if launches["letterbox_normalize"] != N_FRAMES:
        raise AssertionError(f"letterbox kernel launched {launches['letterbox_normalize']} times "
                             f"for {N_FRAMES} frames")
    stream = {k: v.t / N_FRAMES * 1e3 for k, v in zip(("pre_ms", "infer_ms", "post_ms"), dt)}
    stream["pre_h2d_ms"] = h2d_ms(frames)
    print(f"slice: yolov5s-seg 640 fused, {N_FRAMES} frames on cuda, detections per frame "
          f"{[len(d) for d in dets]}, launches {launches}", flush=True)

    # 5. card against CPU, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = copy.deepcopy(model).to("cpu")
    worst = {}
    for i in (1, 2):
        fr = torch.from_numpy(frames[i])[None]
        with torch.inference_mode():
            lv_g, pr_g = model(letterbox_normalize(fr.cuda().contiguous(), 640), decode=False)
            lv_c, pr_c = cpu_model(letterbox_normalize(fr, 640), decode=False)
        for name, g, c in [(f"level{j}", a, b) for j, (a, b) in enumerate(zip(lv_g, lv_c))] + \
                [("protos", pr_g, pr_c)]:
            # rtol 1e-3; entries near zero are held to 1e-3 of the map's largest magnitude
            torch.testing.assert_close(g.cpu(), c, rtol=1e-3, atol=1e-3 * c.abs().max().item())
            worst[name] = max(worst.get(name, 0.0), (g.cpu() - c).abs().max().item())
    gpu2 = predict_images(model, frames[1:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cuda")
    cpu2 = predict_images(cpu_model, frames[1:3], imgsz=640, conf_thres=CONF_LOW, save_img=False,
                          device="cpu")
    shares = []
    for g, c in zip(gpu2, cpu2):
        share = match_detections(c, g)
        shares.append(share)
        if not (abs(len(g) - len(c)) <= 0.02 * len(c) and share >= 0.98):
            raise AssertionError(f"card vs CPU detections: n {len(g)} vs {len(c)}, matched {share}")
    print(f"card vs cpu (tf32 off): raw max abs diff {worst}, kept {[len(g) for g in gpu2]} vs "
          f"{[len(c) for c in cpu2]}, matched share {shares}", flush=True)
    del cpu_model

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
    timing = {"card": card, "tf32": {"cudnn_conv": True, "matmul": False},
              "stream_per_frame": stream, "bs1_640": single, "batched_bs32_640": batched}
    print("timing " + json.dumps(timing), flush=True)

    # 7. kernels line: times averaged over the main path's frames
    mix = [list(MAIN_SHAPES)[i % len(MAIN_SHAPES)] for i in range(N_FRAMES)]
    mean = lambda key: float(np.mean([kres[n][key] for n in mix]))  # noqa: E731
    kernels = [{
        "name": "letterbox_normalize", "route": "cuda",
        "source": "yolo_dual_tpu_torch/csrc/letterbox.cu",
        "replaces": "yolo_dual_tpu/kernels/preprocess.py:91",
        "launches": launches["letterbox_normalize"],
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": "bytes", "library_ms": mean("library_ms"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
