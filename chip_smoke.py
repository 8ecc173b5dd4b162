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
   mIoU >= 0.9285 - 0.05; it runs in a process of its own beside 6e's three
   (`learning_proofs`, `--learning-proof`), all four at once;
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
   RESUME_TOL (atomics); (d) each config's learning proof, as 6d (c) and
   run beside it, at or above its controlled golden
   (tests/test_semantic_golden.py:54-63) less 0.05;
6f. the detect zoo (detect_zoo_path): the 17 configs of the SPP, attention,
   Ghost, Transformer and YOLOv3 modules, the 11 torchvision-backbone configs
   (backbone/*.json) and yolov5s as the control, each at its published width
   and depth, nc 80, 640 px, built by `build_model` on cuda (seeded weights,
   BatchNorm calibrated on 4 seeded frames) behind `AutoShape(fuse=True)`: 4
   seeded frames of the MAIN_SHAPES sizes on the card and on the CPU (TF32
   off): raw head maps within 1e-3 of each map's largest magnitude,
   detections at conf 0.05 paired (boxes within 0.05 px, confidences within
   1e-4; near ties counted; for a torchvision-backbone config that leaves
   rows unpaired, the card's raw maps no further from a float64 CPU run
   than twice the CPU's float32 ones, and the rows paired at the confidence
   gap the raw maps' measured gap admits: earned_pairs); the bs-32 fused
   forward + nms_from_raw in img/s and its peak memory, AutoShape at batch 1
   and 8 in ms a call split into host letterbox / forward + NMS / rescale;
   no kernel launch on this path (AutoShape letterboxes on the host);
6g. classification (classify_path), the card's name and power limit on its
   first line: (a) yolov5s-cls (yolov5s.yaml, cutoff 10) and the 12
   torchvision families through classify.train's `build_classifier`, nc
   1000, 224 px, full width, from JAX's initial weights (`flax_init_`,
   PRNGKey(0)), BatchNorm calibrated on 4 seeded frames: 8 frames card
   against CPU, TF32 off (logits within 1e-4 of their largest magnitude,
   top-5 equal but for counted near ties), the bs-64 eval forward in img/s,
   one bs-64 train micro-step (forward + loss / backward / Adam + EMA ms,
   peak memory); (b) on a seeded 3-class colour set of `.npy` frames under
   build/phase6g (tests/test_classify.py's): classify.train's learning proof
   of JAX's recipe (two-Conv config, cutoff 2, 25 epochs, bs 16, 32 px, lr0
   0.01, deterministic algorithms; best top-1 above 0.9), yolov5s-cls
   trained 2 epochs at 224 px, classify.val on its last.pt (results.csv's
   last top-1), classify.predict on 8 val frames (val's top-1 class each,
   --save-txt rows); no kernel launch on this path (host crop and resize);
6h. AuxOTA, the 6d names, TTA and soft-NMS: (a) `auxota_path`:
   loss/yolov5n_auxota (nc 2, depth 0.33, width 0.25) from JAX's initial
   weights at 640 px, one forward, AuxOTA loss and backward at bs 16 card
   against CPU (TF32 off: both branches' assignment equal, loss items and
   gradients within 1e-3 of the largest), 8 micro-steps through
   Trainer(task="detect") with ComputeLossAuxOTA (hyp.scratch-low,
   accumulate 4, EMA; the parameters move on the boundaries), timed by
   part with peak memory and (after phase 9) the busy share; the EMA model
   served by AutoShape at batch 1 and 8 and the bs-32 forward + NMS; no
   kernel launch; (b) `zoo_6d_path`: ZOO_6D (every name 6d registers, each
   Upsample mode, a DetectAux head) at 640 px card against CPU, eval in
   float32 and train mode in float64 within 1e-4, the card's float32 train
   run no further from the CPU's float64 than the CPU's own; (c, d)
   `tta_path`: segment.val on 6b's set with --augment, --soft-nms and both
   (K1 a batch, mAP50 above 0.05, card against CPU on 8 frames within
   0.01), the NMS of one bs-32 batch timed by variant with the soft-NMS loop
   against JAX's loop and a fixed one, and segment.predict --augment at
   batch 1 (K1 a frame);
6i. the model server and its client (`serve_path`, under build/phase6i):
   (a) yolov5s-seg-dcnv3 as in 4, primed as in 6b, written as a .pt and
   served by `yolo_dual_tpu_torch.serve` on the card (port 0, a daemon
   thread): 24 480x640 and 8 720x1280 PNG requests through
   `io/remote.py:RemoteModel`, each equal (same rows, boxes within 1e-2 px)
   to the host letterbox, fused forward, nms_from_raw and scale_boxes run
   directly on the card; the counts set to 0 before the server starts read
   6 K2 launches a request plus the warm-up's and no K1; the server's parts
   (body read, PNG decode, letterbox, device by CUDA events, JSON) at p50 /
   p90, requests/s of one serial client, and 8 requests card against a CPU
   server, TF32 off (each of the CPU's rows paired within 1e-2 px and 1e-4 or
   an NMS near tie, but for at most 1% of them; each row count within 2%);
   after phase 9 the card's busy share of a profiled
   burst of 8 requests; (b) resnet50.json calibrated as in 6c, served with 8
   PNG-encoded CamVid-style 720x960 frames: shape, class_pixels and the
   decoded class-map PNG equal the direct card forward's; 2 frames card
   against a CPU server, flips only at near ties of the CPU's scores (6c's
   limits); (c) segment.predict on 8 `.npy` frames of 6b's primed
   yolov5s-seg with --save-txt --save-crop --visualize --retina-masks --data
   (a crop a kept detection and a feature map a 4-D layer output, `.npy`
   without cv2 and matplotlib; the txt rows; K1 a frame), and segment.val
   --save-json on 6b's 64 frames (an entry a row the validator's NMS keeps,
   each RLE a mask of its frame's size, K1 a batch, COCOeval None without
   pycocotools; 8 frames card against CPU, TF32 off, max_det 100: entries
   paired within 1e-2 px, masks IoU >= 0.99; masks2segments ms a mask and
   the JSON writer's ms a batch);
6j. weights in and out (`weights_path`, under build/phase6j): (a)
   yolov5s-seg-dcnv3 primed as in 6i and a second member (seed 1), each
   written as a .pt, the first through `export.py --include torchpt`;
   `io/multibackend.py:MultiBackend` of the export (fused) and
   `io/ensemble.py:attempt_load` of both in "cat" and "mean" on a bs-8 640-px
   batch on the card, within 1e-5 of the largest magnitude of the members'
   own card forwards (the same computation); (b) the JAX package's orbax
   checkpoint under tests/data/torch_port_orbax (JAX's save_checkpoint of
   a nano yolov5n-seg with C3_DCNV3 rows, the trainers' layout) read by
   `io/ocdbt.py` with no jax, orbax or tensorstore imported, served by
   MultiBackend on the card with TF32 off, against the committed output of
   JAX's MultiBackend within rtol and atol 1e-4; the K2 count set to 0 just
   before the forwards of (a) and (b) reads 6 a full-width forward and the
   fixture's, and no K1; (c) yolov5s-seg (nc 80, seeded, BatchNorm
   calibrated) exported to ONNX at 640 and run by cv2.dnn on the host,
   against the fused card forward with TF32 off within
   tests/test_onnx_export.py's limits; the read, export, cv2.dnn and
   MultiBackend-against-direct ms;
6l. weights out (`weights_out_path`, under build/phase6l): (a) a copy of the
   orbax fixture stripped by `train/checkpoint.py:strip_optimizer` through
   the port's orbax writer (the write's ms and MB), read back by
   `io/ocdbt.py` (optimizer state and EMA None, epoch -1, variables the
   EMA bit for bit), served by MultiBackend on the card with TF32 off within
   SAME_TOL of the unstripped checkpoint's (EMA-first) forward, and
   `segment.predict --update` on another copy (stripped, then predicted);
   the K2 and K1 counts set to 0 just before these and read just after;
   (b) yolov5s-seg (nc 80, 640, seeded, BatchNorm calibrated) exported by
   `export.py`'s export_savedmodel and export_tflite (float, and int8
   calibrated on JAX's 16 default frames with the lowered graph run on the
   card), each file's ms and MB, and the lowered graph
   (`io/tf_graph.py:run_tf_graph`) on the card no further from the float64
   forward than twice the fused float32 forward is (TF32 off); the machine
   has no tensorflow, so the files' outputs are
   held by tests/test_torch_port_tf_export.py on the CPU;
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
10b. the host augmentation route (host_route_path) on phase 10's set: (a)
   `segment.train` in-process with yolov5s-seg-dcnv3.json, hyp.scratch-high
   (mixup 0.1, copy_paste 0.1: the host route), 640 px, bs 16, f32, 1 epoch,
   --image-weights --cache disk (results.csv finite, last.pt and best.pt
   load strict; the counts set to 0 just before read 6 K2 launches a
   training and a val forward and 6 K3 a micro-step: 36 and 24), its epoch
   img/s beside phase 10's; one bs-16 host batch built in this thread and
   timed by part (load_image, canvas, copy_paste, the warp's pixels and
   labels, mixup, HSV, rasterise); the first micro-step (forward, loss,
   backward) of its first HOST_STEP_BS samples on the card and on the CPU,
   TF32 off: loss items and gradients within HOST_STEP_TOL of the largest;
   (b) --remat on that batch:
   a micro-step with and without it (TF32 off; 12 and 6 K2 launches, 6 K3
   each), loss items and gradients within REMAT_TOL, the BatchNorm statistics
   equal, then each timed with TF32 convolutions, with its peak memory; (c)
   `segment.val --rect --task train` on phase 10's train frames (two
   buckets) labelled with the primed yolov5s-seg's own boxes: the speed line,
   the batches a bucket, box mAP50 above 0.05, and
   RECT_CHECK_FRAMES frames a bucket on the card and on the CPU within
   RECT_MAP_TOL;
6k. data parallelism and the utils layer (`data_parallel_path`, after 10b,
   on a cut of phase 10's set: 16 train and 16 val 480x640 frames), TF32
   off: `python -m torch.distributed.run --standalone --nproc-per-node 2
   chip_smoke.py --dp-rank build/phase6k` starts 2 ranks sharing cuda:0,
   over gloo (parallel/mesh.py's rule), each of which runs (a) one
   accumulation cycle of yolov5s-seg-dcnv3 at 640 px (4 micro-steps, global
   bs 16, 8 a rank) under DDP with the synchronised BatchNorm and again
   with each rank's BatchNorm on its own rows (the fault reference), (b)
   `segment.train --data-parallel --sync-bn --epochs 1` and (c) `segment.val
   --data-parallel --device-preprocess` (K1 a rank's batch) on a set of 32
   frames labelled by the primed model, each with the kernels' counts set
   to 0 just before and read just after; this process runs (a) three times
   as one process (twice with the global batch's rows in the ranks' order,
   the reference and the card's spread, once in their own order) and (c)
   once: the ranks' parameters equal each other, their updates and
   BatchNorm statistics agree with the reference's within DP_UPDATE_TOL and
   DP_STAT_TOL, which lie above the spread and below the fault reference's
   gaps, (b)'s rank 0 wrote results.csv and a last.pt that loads
   here, (c)'s 8 metrics agree within DP_MAP_TOL; then (d) autobatch at 640
   px (bytes a candidate, mem_get_info's total), model_info and profile of
   the fused bs-16 forward (GFLOPs, ms, TFLOP/s), check_bf16, a
   torch.profiler trace under build/phase6k, `segment.train --evolve 1
   --epochs 1` (1 row of evolve.csv; 2 generations until 6m came); a `data
   parallel and utils (6k)` JSON
   line and the phase's seconds;
6m. spatial partitioning (`spatial_path`, after 6k), TF32 off: `python -m
   torch.distributed.run --standalone --nproc-per-node 4 chip_smoke.py
   --sp-rank build/phase6m` starts a dp 2 x sp 2 mesh (parallel/mesh.py:
   make_mesh_2d) of 4 ranks sharing cuda:0 over gloo, each of which runs (a)
   one accumulation cycle (2 micro-steps) of yolov5s-seg-dcnv3 at full width
   and 640 px, global bs 4: 2 rows a data shard, 320 rows a band, every
   Conv and SPPF pool on its band with halo rows, DCNv3's sampling through
   K2 and K3 on the band's rows (`row0`); (b) the same cycle with every band
   padded by its edge fill instead of its neighbours' rows (halo_rows
   replaced in this script: the fault reference); (c) evaluate_segment of 8
   self-labelled frames (K1 a rank's batch), each with the kernels' counts
   set to 0 just before and read just after; this process runs (a) twice on
   the global batch (the reference and the card's spread) and (c) once, the
   cycles on cuDNN's deterministic algorithms, and first holds K2 and K3 with row0 != 0 against their plain versions at each
   DCN_PATH_SHAPES map split into 2 bands: the ranks' parameters equal each
   other, updates and statistics agree with the reference within
   SP_UPDATE_TOL and SP_STAT_TOL (above the spread, below the fault's gaps),
   the metrics within DP_MAP_TOL; a `spatial partitioning (6m)` JSON line
   (micro-step ms and peak bytes, ranks against one process, the gaps and
   their limits, the exchanges a rank's cycle, the launches);
11. a JSON line of every kernel with its launches on the main paths, then the
   JSON result line.

`--proof-spread RUNS` runs phase 1 and the four learning proofs of 6d (c)
and 6e (d) only, each RUNS times with deterministic algorithms (as the phases
run them) and RUNS times without, with each run's best mIoU and a digest of
its last.pt; it fails when two deterministic runs of a config differ, and
prints no result line.

`--sp-spread RUNS` runs phase 1 and 6m's one-process cycle only, RUNS times
in each of four settings of deterministic algorithms (sp_spread), with each
setting's gaps between its runs, and prints no result line.

`--device-times ROOT` runs phase 1, phase 3's K1 cases (checked, and timed
through the wrapper) and phase 9's device times at every K1 case and DCNv3
path shape only, with the package of the checkout at ROOT (default: this one),
for instance the parent commit unpacked with `git archive`: the same
measurement of two versions in one call. It prints no result line.
"""

from __future__ import annotations

import argparse
import base64
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
    long process a session can hold another number of records than launches
    (each session's count is printed then): it is run again, up to three
    times; where none held `iters`, the time is the mean over the records of
    the session that held the most (each record is one launch's own time),
    and "not measured" only where no session held one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in events)
        total = sum(e.self_device_time_total for e in events)
        if count == iters:
            return total / iters / 1e3
        seen.append((count, total))
    print(f"profiler records of {kernel} in 3 sessions of {iters} launches: "
          f"{[c for c, _ in seen]}", flush=True)
    count, total = max(seen)
    return total / count / 1e3 if count else "not measured"


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
    x = torch.cat([letterbox_normalize(torch.from_numpy(f)[None].cuda(), 640, fill=fill)
                   for f in frames])
    return calibrate_bn_on(model, x)


def calibrate_bn_on(model, x):
    """Set every BatchNorm's running statistics to those of the model's input
    batch `x` (calibrate_bn's core)."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # cumulative average: one batch gives its own statistics
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
    finally:
        probe.close()
    PROOFS.update(learning_proofs(scene, root))
    golden = PROOFS.pop("resnet50.json")
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
    hyp = root / f"hyp_{name}.json"   # a file a proof: learning_proofs runs four at once
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


# the four learning proofs run at once, each in its own process (learning_proofs), started by
# phase 6d; 6e reads the YOLO configs' results from here
PROOFS: dict = {}


def learning_proofs(scene, root: Path) -> dict:
    """The learning proofs of resnet50.json (6d) and YOLO_SEM_CFGS (6e), each
    `learning_proof` in a process of its own (`chip_smoke.py --learning-proof
    CFG NAME ROOT`), all four at once: they are host-bound (96 px, bs 4), and
    one after another they took 180–265 s. Each process runs under
    deterministic algorithms and counts its own K1 launches, so a proof's
    result does not depend on the others beside it; its `run_s` is its wall
    clock beside them. Returns {cfg: learning_proof's result}; a process that
    fails raises with the tail of its log."""
    runs = {"resnet50.json": "golden", **{c: f"{c.removesuffix('.json')}_golden"
                                          for c in YOLO_SEM_CFGS}}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {}
    for cfg, name in runs.items():   # stdout and stderr to files: a full pipe would block
        with open(root / f"{name}.out", "w") as o, open(root / f"{name}.log", "w") as e:
            procs[cfg] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--learning-proof", cfg, name,
                 str(root), str(scene[0]), str(scene[1])], stdout=o, stderr=e, env=env,
                cwd=Path(__file__).resolve().parent)
    out = {}
    for cfg, proc in procs.items():
        proc.wait(timeout=900)
        lines = [ln for ln in (root / f"{runs[cfg]}.out").read_text().splitlines()
                 if ln.startswith("learning proof result ")]
        if proc.returncode or not lines:
            tail = (root / f"{runs[cfg]}.log").read_text()[-3000:]
            raise AssertionError(f"learning proof of {cfg} exited {proc.returncode}: {tail}")
        out[cfg] = json.loads(lines[-1].removeprefix("learning proof result "))
    return out


def learning_proof_process(cfg: str, name: str, root: Path, scene) -> int:
    """`--learning-proof`: one learning proof in this process, its result as a
    JSON line."""
    from yolo_dual_tpu_torch.kernels.build import load_library
    from yolo_dual_tpu_torch.semantic import train as cli
    torch.set_num_threads(2)
    load_library("letterbox")
    probe = CliProbe(cli)
    try:
        res = learning_proof(probe, scene, root, root / "runs", cfg, name)
    finally:
        probe.close()
    print("learning proof result " + json.dumps(res), flush=True)
    return 0


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
            # (d) the learning proof, run beside 6d's (learning_proofs)
            proof = PROOFS.pop(cfg)
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
# Transformer and YOLOv3 modules, the 11 torchvision-backbone configs (by their folder-qualified
# names: backbone/resnet18 and backbone/resnet50 share their stems with semantic configs), and
# yolov5s as the control.
TV_BACKBONES = ("MobileNetV3s", "RegNety400", "convnext_tiny", "efficientnet_b0",
                "efficientnet_b1", "efficientnet_v2_s", "mobilenet_v2", "resnet18", "resnet50",
                "vgg11_bn", "wide_resnet50_2")
DETECT_ZOO = ("yolov5s.json", "yolov5n-ASPP.json", "yolov5n-RFB.json", "yolov5n-SPP.json",
              "yolov5n-SPPCSPC.json", "yolov5n-SPPCSPC_group.json", "yolov5n-SimCSPSPPF.json",
              "yolov5n-SimSPPF.json", "yolov5n-FPN+PAN-AC.json", "yolov5n-FPN+PAN-AS.json",
              "yolov5n-FPN-AC.json", "yolov5n-FPN-AS.json", "yolov5n-PAN-AC.json",
              "yolov5n-PAN-AS.json", "yolov3-spp.json", "yolov3-tiny.json", "yolov5s-ghost.json",
              "yolov5s-transformer.json") + tuple(f"backbone/{b}.json" for b in TV_BACKBONES)
ZOO_CONF = 0.05  # checks and timed calls: a random network keeps few or no rows at 0.25
ZOO_CHECK_MAX_DET = 1000  # card vs CPU: no max_det cut
ZOO_RAW_TOL = 1e-3  # card vs CPU, TF32 off: raw head maps within this share of a map's largest
ZOO_BOX_TOL, ZOO_CONF_TOL, ZOO_NEAR = 0.05, 1e-4, 1e-4  # px; confidence; a near tie
ZOO_FRAMES, ZOO_BATCH = 4, 8


def earned_pairs(cpu_model, x, raw_g, raw_c, pair_all, left):
    """The torchvision-backbone configs' fallback when detections do not pair
    at ZOO_CONF_TOL (their deep stages keep unfused BatchNorms and amplify
    float32 rounding more than the PR 11 configs: wide_resnet50_2 left one
    row 1.16e-4 apart in confidence, its raw maps 7.3e-5 of their largest
    magnitude apart). The CPU model in float64 is the reference: the card's
    raw maps must stand no further from it than twice the CPU's float32 maps
    do (of each map's largest magnitude), and every detection must pair at
    the confidence gap the measured raw maps admit (a confidence is
    sigmoid(a)·sigmoid(b): it moves at most half the largest raw change).
    Returns (what was measured, the rows still unpaired)."""
    with torch.inference_mode():
        raw_64 = copy.deepcopy(cpu_model).double()(x.double() / 255, decode=False)
    card = [((g.cpu().double() - r).abs().max() / r.abs().max()).item()
            for g, r in zip(raw_g, raw_64)]
    cpu = [((c.double() - r).abs().max() / r.abs().max()).item() for c, r in zip(raw_c, raw_64)]
    conf_tol = max(ZOO_CONF_TOL, 0.5 * max((g.cpu() - c).abs().max().item()
                                           for g, c in zip(raw_g, raw_c)))
    pairs, ties, left2 = pair_all(conf_tol)
    ok = all(a <= 2 * b for a, b in zip(card, cpu))
    out = {"unpaired_at_conf_tol": left, "card_vs_float64": card, "cpu_vs_float64": cpu,
           "conf_tol": conf_tol, "pairs": pairs, "near_ties": ties}
    return out, (left2 if ok else left + [f"card {card} vs float64, CPU {cpu}"])


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

        def pair_all(conf_tol):
            pairs = ties = 0
            left = []
            for w, g in zip(want.dets, got.dets):
                n, t, lw, lg = pair_detections(w, g, ZOO_CONF, box_tol=ZOO_BOX_TOL,
                                               conf_tol=conf_tol, near=ZOO_NEAR)
                pairs, ties = pairs + n, ties + t
                left += [r.tolist() for r in (*lw, *lg)]
            return pairs, ties, left
        pairs, ties, left = pair_all(ZOO_CONF_TOL)
        row["card_vs_cpu"] = {"raw_max_rel_diff": raw, "detections": [len(d) for d in got.dets],
                              "cpu_detections": [len(d) for d in want.dets], "pairs": pairs,
                              "near_ties": ties}
        if left and cfg.startswith("backbone/"):
            row["card_vs_cpu"]["earned"], left = earned_pairs(cpu_model, x, raw_g, raw_c,
                                                              pair_all, left)
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


# Phase 6g: classification (classify.train, .val, .predict and build_classifier's models), nc 1000,
# 224 px, full width: yolov5s-cls (yolov5s.yaml, cutoff 10) and the 12 torchvision families.
CLS_MODELS = ("yolov5s.yaml", "resnet18", "resnet34", "resnet50", "wide_resnet50_2",
              "MobileNetV3s", "mobilenet_v2", "efficientnet_b0", "efficientnet_b1",
              "efficientnet_v2_s", "RegNety400", "vgg11_bn", "convnext_tiny")
CLS_IMGSZ, CLS_BS, CLS_CHECK = 224, 64, 8
CLS_LOGIT_TOL = 1e-4  # card vs CPU, TF32 off: logits within this share of their largest
CLS_NEAR = 2 * CLS_LOGIT_TOL  # a top-5 swap between classes this close (same share) is a near tie
# (b): tests/test_classify.py's colour set and two-Conv config, and its recipe (25 epochs, bs 16,
# 32 px, lr0 0.01, seed 0, augmentation on), whose criterion is a best top-1 above 0.9
CLS_COLORS = {"red": (220, 30, 30), "green": (30, 220, 30), "blue": (30, 30, 220)}
CLS_MINI = dict(nc=3, depth_multiple=1.0, width_multiple=1.0,
                backbone=[[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]]], head=[])
CLS_PROOF_FLOOR = 0.9


def write_colour_set(root: Path, n_per_class: int = 24, size: int = 48, seed: int = 0):
    """tests/test_classify.py:_make_imageset as RGB uint8 `.npy` frames (the
    card has no cv2): a dark noise frame with a dominant field of its class's
    colour; train/ n_per_class and val/ n_per_class // 3 frames a class."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_per_class), ("val", max(n_per_class // 3, 4))):
        for cname, rgb in CLS_COLORS.items():
            d = root / split / cname
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                im = rng.integers(0, 60, (size, size, 3), dtype=np.uint8)
                x0, y0 = rng.integers(0, size // 4, 2)
                im[y0:y0 + size // 2 + 8, x0:x0 + size // 2 + 8] = rgb
                np.save(d / f"{i}.npy", im)


def top5_swaps(got: np.ndarray, want: np.ndarray, near: float):
    """The rows' top-5 classes, card against CPU: (near ties, other swaps),
    a near tie being a position where the two classes' CPU logits stand
    within `near` of each other."""
    ties, bad = 0, []
    for r, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(np.argsort(-g)[:5], np.argsort(-w)[:5]):
            if a != b:
                if abs(w[a] - w[b]) <= near:
                    ties += 1
                else:
                    bad.append((r, int(a), int(b)))
    return ties, bad


def classify_micro_step(model, x: torch.Tensor, labels: torch.Tensor, steps: int = 5) -> dict:
    """classify.train's step at its defaults (Adam, lr0 1e-3, cosine, EMA,
    label smoothing 0.1) on one batch: forward + loss / backward / Adam + EMA
    ms each (CUDA events), the mean of the steps after two warm-ups; the
    losses and the peak memory."""
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import classify_loss
    opt = smart_optimizer(model, "Adam", dict(lr0=1e-3, lrf=0.01, momentum=0.9,
                                              weight_decay=5e-5, warmup_epochs=0.0),
                          epochs=10, steps_per_epoch=100, cos_lr=True)
    ema = ModelEMA(model, decay=0.9999, tau=2000.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts, losses = np.zeros(3), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.train()
    for i in range(steps):
        model.zero_grad(set_to_none=True)
        ev[0].record()
        loss = classify_loss(model(x), labels, 0.1)[0]
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ema.update(model)
        ev[3].record()
        torch.cuda.synchronize()
        losses.append(loss.item())
        if i >= 2:
            parts += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
    parts /= steps - 2
    return {"forward_loss_ms": parts[0], "backward_ms": parts[1], "adam_ema_ms": parts[2],
            "micro_step_ms": float(parts.sum()), "losses": losses,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def classify_path(card: str) -> dict:
    """Phase 6g. (a) Each of CLS_MODELS built by classify.train's
    `build_classifier` on the card at nc 1000, from JAX's initial weights
    under PRNGKey(0) (`flax_init_`), BatchNorm calibrated on 4 seeded frames
    (classify_transforms at 224 px): CLS_CHECK frames card against CPU with
    TF32 off (logits within CLS_LOGIT_TOL of their largest magnitude, top-5
    equal but for counted near ties); the bs-64 eval forward in img/s (CUDA
    events, TF32 convolutions); one bs-64 train micro-step split as forward
    + loss / backward / Adam + EMA and its peak memory. (b) The CLIs
    in-process on a seeded colour set under build/phase6g: classify.train's
    learning proof of JAX's recipe under deterministic algorithms (best top-1
    above CLS_PROOF_FLOOR); yolov5s-cls trained 2 epochs at 224 px, bs 16;
    classify.val on its last.pt gives results.csv's last top-1;
    classify.predict on 8 val frames gives val's top-1 class for each (near
    ties counted) and writes its --save-txt rows. Every failure fails the
    phase. The path launches none of K1-K3 (the classify data path crops and
    resizes on the host): the counts, set to 0 before and read after, are
    returned."""
    import shutil
    from yolo_dual_tpu_torch.classify import predict as predict_cli
    from yolo_dual_tpu_torch.classify import train as train_cli
    from yolo_dual_tpu_torch.classify import val as val_cli
    from yolo_dual_tpu_torch.data.classify import classify_transforms
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.flax_init import flax_init_
    kernels = (letterbox_normalize, dcnv3_sampling, dcnv3_sampling_backward)
    print(f"classify (6g) on {card}: {len(CLS_MODELS)} models, nc 1000, {CLS_IMGSZ} px",
          flush=True)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False

    def batch(frames):
        return torch.from_numpy(np.stack([classify_transforms(f, CLS_IMGSZ) for f in frames])
                                ).permute(0, 3, 1, 2).contiguous()
    calib, check = batch(make_frames(4, seed=7)), batch(make_frames(CLS_CHECK, seed=8))
    x64 = check.repeat(CLS_BS // CLS_CHECK, 1, 1, 1).cuda()
    labels = torch.arange(CLS_BS, device="cuda") % 1000
    for k in kernels:
        k.launches = 0
    failures, rows = [], []
    for name in CLS_MODELS:
        t0 = time.perf_counter()
        torch.backends.cudnn.allow_tf32 = True
        model = flax_init_(train_cli.build_classifier(name, 1000, device="cuda"))
        calibrate_bn_on(model, calib.cuda())
        row = {"model": name, "params": sum(p.numel() for p in model.parameters()),
               "build_s": time.perf_counter() - t0}

        torch.backends.cudnn.allow_tf32 = False
        cpu_model = copy.deepcopy(model).cpu()
        with torch.inference_mode():
            got = model(check.cuda()).cpu().numpy()
            want = cpu_model(check).numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        ties, swaps = top5_swaps(got, want, CLS_NEAR * scale)
        row["card_vs_cpu"] = {"logits_max_rel_diff": err, "top5_near_ties": ties,
                              "top5_swaps": swaps, "top1_cpu": np.argmax(want, 1).tolist()}
        if err > CLS_LOGIT_TOL or swaps or not np.isfinite(got).all():
            failures.append(f"{name}: logits {err}, top-5 swaps {swaps}")
        del cpu_model

        torch.backends.cudnn.allow_tf32 = True

        def forward():
            with torch.inference_mode():
                return model(x64)
        row["bs64_eval_img_per_s"] = CLS_BS / (cuda_ms(forward, 10) / 1e3)
        row["bs64_train"] = classify_micro_step(model, x64, labels)
        if not np.isfinite(row["bs64_train"]["losses"]).all():
            failures.append(f"{name}: train losses {row['bs64_train']['losses']}")
        row["phase_s"] = time.perf_counter() - t0
        print("classify " + json.dumps(row), flush=True)
        rows.append(row)
        del model, forward
        torch.cuda.empty_cache()

    # (b) the CLIs
    root = Path(__file__).resolve().parent / "build" / "phase6g"
    shutil.rmtree(root, ignore_errors=True)
    write_colour_set(root / "data")
    (root / "mini.json").write_text(json.dumps(CLS_MINI))
    project = root / "runs"
    t = time.perf_counter()
    with deterministic_algorithms():
        best = train_cli.main(["--model", str(root / "mini.json"), "--data-dir",
                               str(root / "data"), "--cutoff", "2", "--epochs", "25",
                               "--batch-size", "16", "--imgsz", "32", "--lr0", "0.01", "--seed",
                               "0", "--project", str(project), "--name", "proof", "--device",
                               "cuda"])
    proof_s = time.perf_counter() - t
    t = time.perf_counter()
    train_cli.main(["--model", "yolov5s.yaml", "--data-dir", str(root / "data"), "--epochs", "2",
                    "--batch-size", "16", "--imgsz", str(CLS_IMGSZ), "--project", str(project),
                    "--name", "v5s", "--device", "cuda"])
    v5s_s = time.perf_counter() - t
    with open(project / "v5s" / "results.csv") as f:
        res = np.array([r.split(",") for r in f.read().split()[1:]], np.float64)
    last = project / "v5s" / "last.pt"
    top1, top5 = val_cli.run(weights=str(last), model="yolov5s.yaml",
                             data_dir=str(root / "data"), imgsz=CLS_IMGSZ, batch_size=16,
                             device="cuda")
    logits = val_cli.run.logits[:8]  # val/blue/0..7, the first class folder
    pred = predict_cli.run(weights=str(last), model="yolov5s.yaml",
                           source=str(root / "data" / "val" / "blue"), imgsz=CLS_IMGSZ, topk=5,
                           nosave=True, save_txt=True, project=str(project), name="predict",
                           exist_ok=True, device="cuda")
    near = CLS_NEAR * float(np.abs(logits).max())
    pred_ties, pred_bad = 0, []
    for i, (_, order, _) in enumerate(pred):
        want_cls, got_cls = int(np.argmax(logits[i])), int(order[0])
        if got_cls != want_cls:
            if abs(logits[i, got_cls] - logits[i, want_cls]) <= near:
                pred_ties += 1
            else:
                pred_bad.append((i, got_cls, want_cls))
    txt = sorted(p.name for p in (project / "predict" / "labels").glob("*.txt"))
    cli = {"proof_best_top1": best, "proof_floor": CLS_PROOF_FLOOR, "proof_s": proof_s,
           "v5s_2_epochs_s": v5s_s, "v5s_results": res.tolist(), "val_top1_top5": [top1, top5],
           "predict_top1": [int(o[0]) for _, o, _ in pred], "predict_near_ties": pred_ties,
           "predict_txt_rows": len(txt)}
    launches = {k.__name__: k.launches for k in kernels}
    print(f"classify cli ({card}) " + json.dumps(cli), flush=True)
    print(f"classify phase s {time.perf_counter() - t_phase:.2f}", flush=True)
    if not best > CLS_PROOF_FLOOR:
        failures.append(f"learning proof: best top-1 {best} <= {CLS_PROOF_FLOOR}")
    if res.shape != (2, 4) or not np.isfinite(res).all() or top1 != res[-1, 2]:
        failures.append(f"yolov5s-cls: results {res.tolist()}, val top-1 {top1}")
    if len(pred) != 8 or pred_bad or len(txt) != 8:
        failures.append(f"predict: {len(pred)} frames, top-1 against val {pred_bad}, "
                        f"{len(txt)} txt files")
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError("classify: " + "; ".join(failures))
    return launches


# Phase 6h: the AuxOTA dual head (loss/yolov5n_auxota at its published depth and width, nc 2,
# JAX's initial weights, 640 px), a graph of every registry name no shipped config uses (6d),
# and segment.val / segment.predict with TTA and soft-NMS.
ZOO_6D = {  # every name 6d registers, and each Upsample mode; a DetectAux head over 6 maps
    "nc": 80, "depth_multiple": 0.33, "width_multiple": 0.25,
    "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]],
    "backbone": [[-1, 1, "Focus", [64, 3]],                       # 0  P1/2
                 [-1, 1, "Conv", [128, 3, 2]],                    # 1  P2/4
                 [-1, 3, "BottleneckCSP", [128]],                 # 2
                 [-1, 1, "DWConv", [256, 3, 2]],                  # 3  P3/8
                 [-1, 6, "C3x", [256]],                           # 4
                 [-1, 1, "Conv", [512, 3, 2]],                    # 5  P4/16
                 [-1, 1, "MixConv2d", [512, [3, 5, 7]]],          # 6
                 [-1, 1, "Conv", [1024, 3, 2]],                   # 7  P5/32
                 [-1, 1, "C3SPP", [1024, [5, 9, 13]]],            # 8
                 [-1, 1, "nn.BatchNorm2d", []]],                  # 9
    "head": [[-1, 1, "Conv", [512, 1, 1]],                        # 10
             [-1, 1, "nn.ConvTranspose2d", [512, 2, 2, 0]],       # 11 P4
             [[-1, 6], 1, "Sum", [2, True]],                      # 12
             [-1, 1, "Conv", [256, 1, 1]],                        # 13
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],        # 14 P3
             [[-1, 4], 1, "Concat", [1]],                         # 15
             [-1, 1, "CrossConv", [256, 3, 1]],                   # 16 lead P3
             [-1, 1, "Contract", [2]],                            # 17 P4
             [[-1, 13], 1, "Concat", [1]],                        # 18
             [-1, 1, "Conv", [512, 1, 1]],                        # 19 lead P4
             [-1, 1, "nn.Upsample", [None, 0.5, "nearest"]],      # 20 P5: nearest at factor 0.5
             [[-1, 10], 1, "Concat", [1]],                        # 21
             [-1, 1, "Conv", [1024, 1, 1]],                       # 22 lead P5
             [19, 1, "Expand", [2]],                              # 23 P3
             [-1, 1, "DWConvTranspose2d", [256, 3, 1, 1]],        # 24 aux P3
             [22, 1, "nn.Upsample", [None, 2, "bilinear"]],       # 25 aux P4: bilinear, enlarging
             [16, 1, "nn.Upsample", [[30, 30], None, "nearest"]],  # 26 nearest to a size
             [-1, 1, "nn.Upsample", [[20, 20], None, "bilinear"]],  # 27 aux: bilinear, shrinking
             [[16, 19, 22, 24, 25, 27], 1, "Detect", ["nc", "anchors"]]]}  # 28 DetectAux


AUX_CFG, AUX_BS, AUX_STEPS, AUX_MAX_BOXES = "yolov5n_auxota.json", 16, 8, 8
AUX_TOL = 1e-3  # card vs CPU, TF32 off: loss items and gradients within this share of the largest
AUX_SERVE_CONF = 1e-3  # after 8 micro-steps from JAX's init the scores sit far below 0.25
ZOO_6D_TOL = 1e-4  # card vs CPU, TF32 off: 6d graph outputs within this share of the largest
ZOO_6D_F64_TOL = 1e-9  # the same in float64, train mode (read 1.2e-12; float32 reads 2.6e-6)
TTA_RUNS = {"augment": dict(augment=True), "soft_nms": dict(soft_nms=True),
            "augment_soft_nms": dict(augment=True, soft_nms=True)}
TTA_PREDICT_FRAMES = 8


def detect_batch(rng: np.random.Generator, bs: int, imgsz: int, nc: int, device) -> dict:
    """One seeded detect batch as the JAX package's loader yields it: uint8
    NHWC images, targets (bs, AUX_MAX_BOXES, 5) normalised [cls, x, y, w, h]
    with 1..AUX_MAX_BOXES boxes an image of classes below nc, their mask."""
    targets = np.zeros((bs, AUX_MAX_BOXES, 5), np.float32)
    tmask = np.zeros((bs, AUX_MAX_BOXES), bool)
    for i in range(bs):
        n = int(rng.integers(1, AUX_MAX_BOXES + 1))
        wh = rng.uniform(0.05, 0.5, (n, 2))
        targets[i, :n] = np.concatenate([rng.integers(0, nc, (n, 1)),
                                         rng.uniform(wh / 2, 1 - wh / 2), wh], 1)
        tmask[i, :n] = True
    image = rng.integers(0, 256, (bs, imgsz, imgsz, 3), dtype=np.uint8)
    return {k: torch.from_numpy(v).to(device) for k, v in
            dict(image=image, targets=targets, tmask=tmask).items()}


def auxota_trainer(model):
    """Trainer(task="detect") of `model` with ComputeLossAuxOTA, SGD with
    hyp.scratch-low (bs AUX_BS, accumulate to 64) and the EMA."""
    from yolo_dual_tpu_torch.losses.ota import ComputeLossAuxOTA
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg("hyp.scratch-low.json"))
    head = model.model[-1]
    opt = smart_optimizer(model, "SGD", hyp, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                          accumulate=max(round(64 / AUX_BS), 1), total_batch_size=AUX_BS)
    trainer = Trainer(model, ComputeLossAuxOTA(head.anchors, head.strides, model.nc, hyp), opt,
                      ModelEMA(model), task="detect")
    return trainer, trainer.init_state()


def share(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over max |b| (b on the CPU)."""
    return ((a.detach().cpu().double() - b.detach().double()).abs().max()
            / b.detach().double().abs().max().clamp(min=1e-30)).item()


def auxota_card_vs_cpu(model, batch) -> dict:
    """One forward, AuxOTA loss and backward of `model` (deep copies, train
    mode) on the card and on the CPU, TF32 off: the assignment of both
    branches (fgs, matched_gts) equal, the loss items and every gradient
    within AUX_TOL of the largest."""
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).train()
        trainer, _ = auxota_trainer(m)
        b = {k: v.to(dev) for k, v in batch.items()}
        p = m(trainer.model_input(b["image"]), decode=False)
        lf = trainer.loss_fn
        with torch.no_grad():
            sel = [lf._simota_select(p[:lf.nl], b["targets"], b["tmask"], lf._pixel_scale(p),
                                     bias=bias) for bias in (0.5, 1.0)]
        loss, items = lf(p, b["targets"], b["tmask"])
        loss.backward()
        out[dev] = {"sel": [{k: s[k].cpu() for k in ("fgs", "matched_gts")} for s in sel],
                    "items": items.cpu(), "grads": {k: q.grad.cpu() for k, q in m.named_parameters()}}
    g, c = out["cuda"], out["cpu"]
    res = {"fg_lead": int(c["sel"][0]["fgs"].sum()), "fg_aux": int(c["sel"][1]["fgs"].sum()),
           "assignment_equal": all(torch.equal(a[k], b[k]) for a, b in zip(g["sel"], c["sel"])
                                   for k in ("fgs", "matched_gts")),
           "items_card": g["items"].tolist(), "items_cpu": c["items"].tolist(),
           "items_share": share(g["items"], c["items"]),
           "grad_share_max": max(share(g["grads"][k], v) for k, v in c["grads"].items()
                                 if v.abs().max() > 0)}
    torch.backends.cudnn.allow_tf32 = True
    return res


def auxota_path(card: str):
    """Phase 6h (a): loss/yolov5n_auxota at its published depth and width (nc
    2), JAX's initial weights (`flax_init_`, PRNGKey(0) and the bias prior),
    640 px. Card against CPU on the first batch (auxota_card_vs_cpu); then
    AUX_STEPS micro-steps at bs AUX_BS through Trainer(task="detect") with
    ComputeLossAuxOTA and hyp.scratch-low on seeded boxes (the parameters move
    on the accumulation boundaries, the EMA with them), timed by part (CUDA
    events: forward, OTA loss, backward, optimizer + EMA) with peak memory.
    Then served, fused: AutoShape at batch 1 and 8 (ms by part, host clock)
    and the bs-32 forward + nms_from_raw over the lead levels in img/s.
    Returns (launches: none of K1-K3 is on the path, a function profiling
    one accumulation cycle after phase 9)."""
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.engine.autoshape import AutoShape
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.flax_init import flax_init_
    from yolo_dual_tpu_torch.models.model import build_model
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    kernels = (letterbox_normalize, dcnv3_sampling, dcnv3_sampling_backward)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    model = flax_init_(build_model(AUX_CFG, device="cuda"))
    head = model.model[-1]
    assert type(head).__name__ == "DetectAux" and model.nc == 2, type(head)
    rng = np.random.default_rng(8)
    batches = [detect_batch(rng, AUX_BS, 640, model.nc, "cuda") for _ in range(AUX_STEPS)]
    check = auxota_card_vs_cpu(model, batches[0])
    print(f"auxota card vs cpu ({card}; bs {AUX_BS}, 640 px, tf32 off) " + json.dumps(check),
          flush=True)
    failures = []
    if not (check["assignment_equal"] and check["items_share"] <= AUX_TOL
            and check["grad_share_max"] <= AUX_TOL and check["fg_lead"] > 0):
        failures.append(f"card vs CPU {check}")

    trainer, state = auxota_trainer(model)
    accumulate = state.optimizer.accumulate
    for k in kernels:
        k.launches = 0
    items, moved = [], []
    params = list(model.parameters())
    for batch in batches:
        before = torch.cat([q.detach().flatten() for q in params])
        state, metrics = trainer.train_step(state, batch)
        moved.append(not torch.equal(before, torch.cat([q.detach().flatten() for q in params])))
        items.append(metrics["items"].tolist())
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    boundaries = [(i + 1) % accumulate == 0 for i in range(AUX_STEPS)]
    if not np.isfinite(items).all() or moved != boundaries \
            or state.ema.updates != AUX_STEPS // accumulate or any(launches.values()):
        failures.append(f"micro-steps: items {items}, moved {moved}, EMA {state.ema.updates}, "
                        f"launches {launches}")

    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    split = []
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        e = [ev() for _ in range(5)]
        model.zero_grad(set_to_none=True)
        e[0].record()
        x = trainer.model_input(batch["image"])
        p = model(x, decode=False)
        e[1].record()
        loss, _ = trainer.loss_fn(p, batch["targets"], batch["tmask"])
        e[2].record()
        loss.backward()
        e[3].record()
        trainer.apply_gradients(state)
        e[4].record()
        split.append(e)
    torch.cuda.synchronize()
    parts = np.array([[a.elapsed_time(b) for a, b in zip(e, e[1:])] for e in split])
    real = [i for i in range(AUX_STEPS) if boundaries[i]]
    step_ms = cuda_ms(lambda: trainer.train_step(state, batches[0]), AUX_STEPS, warmup=0)
    train = {"cfg": AUX_CFG, "card": card, "bs": AUX_BS, "imgsz": 640, "accumulate": accumulate,
             "params": sum(q.numel() for q in params), "items": items,
             "micro_step_ms": step_ms, "img_per_s": AUX_BS / (step_ms / 1e3),
             "forward_ms": float(parts[:, 0].mean()), "ota_loss_ms": float(parts[:, 1].mean()),
             "backward_ms": float(parts[:, 2].mean()),
             "optimizer_ema_ms": float(parts[:, 3].mean()),
             "optimizer_ema_ms_on_real_steps": float(parts[real, 3].mean()),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("auxota train " + json.dumps(train), flush=True)

    # serving: the EMA model, fused, behind AutoShape; the bs-32 forward + NMS of the lead levels
    serve_model = copy.deepcopy(state.ema.ema).eval()
    calibrate_bn(serve_model, make_frames(4, seed=6))
    api = AutoShape(serve_model, imgsz=640, conf=AUX_SERVE_CONF)
    frames = make_frames(ZOO_FRAMES, seed=5)
    x32 = torch.from_numpy(np.stack([letterbox(f, 640)[0] for f in frames])).permute(0, 3, 1, 2)
    x32 = x32.repeat(32 // len(frames), 1, 1, 1).cuda().float() / 255

    def step():
        with torch.inference_mode():
            raw = serve_model(x32, decode=False)
            return nms_from_raw(raw[:head.nl], head.anchors, head.strides,
                                conf_thres=AUX_SERVE_CONF, max_det=300)

    def autoshape_ms(batch):
        api(batch)
        parts = np.zeros(3)
        for _ in range(3):
            out = api(batch)
            parts += np.array(out.t) * len(batch) / 3
        return {"letterbox": parts[0], "forward_nms": parts[1], "rescale": parts[2],
                "call": float(parts.sum()), "rows": sum(len(d) for d in out.dets)}
    for k in kernels:
        k.launches = 0
    serve = {"autoshape_bs1_ms": [{"frame": "x".join(map(str, f.shape[:2])), **autoshape_ms([f])}
                                  for f in frames],
             f"autoshape_bs{ZOO_BATCH}_ms": autoshape_ms(
                 [frames[i % len(frames)] for i in range(ZOO_BATCH)])}
    serve["bs32_img_per_s"] = 32 / (cuda_ms(step, 10) / 1e3)
    serve["bs32_rows"] = int(step()[1].sum())
    serve["launches"] = {k.__name__: k.launches for k in kernels}
    serve["phase_s"] = time.perf_counter() - t_phase
    print(f"auxota serve ({card}) " + json.dumps(serve), flush=True)
    if any(serve["launches"].values()):
        failures.append(f"serving launched {serve['launches']}")
    if failures:
        raise AssertionError("auxota (6h a): " + "; ".join(failures))
    del serve_model, api, x32

    def profile():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        return profile_steps(trainer, state, batches[:accumulate], step_ms)
    return launches, profile


def zoo_6d_path(card: str) -> dict:
    """Phase 6h (b): ZOO_6D (every registry name 6d adds, each Upsample mode,
    a DetectAux head) at 640 px, seeded weights with BatchNorm calibrated on 4
    frames, bs 2, TF32 off. Eval (the decoded output and the 6 raw levels):
    card against CPU in float32 within ZOO_6D_TOL of each output's largest
    magnitude. Train mode: train-mode BatchNorm over these images (means far
    above their spread) puts float32's own rounding above ZOO_6D_TOL (the
    CPU's float32 against its float64: 2.6e-5 after the first layer, ~5e-4 at
    the head), so the card is held against the CPU in float64 within
    ZOO_6D_F64_TOL, which a float32 computation would break, and its float32 run against the CPU's float64 no further off
    than the CPU's float32 run (card <= 2 · CPU + ZOO_6D_TOL / 10)."""
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(ZOO_6D, device="cuda", generator=torch.Generator().manual_seed(0))
    calibrate_bn(model, make_frames(4, seed=6))
    x = torch.from_numpy(np.stack([letterbox(f, 640)[0] for f in make_frames(2, seed=9)]))
    x = x.permute(0, 3, 1, 2).float() / 255
    res = {"params": sum(q.numel() for q in model.parameters()),
           "strides": list(model.spec.strides)}

    def run(m, mode, dev, dtype):
        m = copy.deepcopy(m).to(dev, dtype).train(mode == "train")
        with torch.no_grad():
            out = m(x.to(dev, dtype))
        return [out[0], *out[1]] if mode == "eval" else list(out)
    eval_g, eval_c = run(model, "eval", "cuda", torch.float32), run(model, "eval", "cpu",
                                                                   torch.float32)
    res["eval_f32_card_vs_cpu"] = [share(g, c) for g, c in zip(eval_g, eval_c)]
    res["eval_shapes"] = [list(t.shape) for t in eval_c]
    tr = {(dev, dt): run(model, "train", dev, dt) for dev in ("cuda", "cpu")
          for dt in (torch.float32, torch.float64)}
    c64 = tr[("cpu", torch.float64)]
    res["train_f64_card_vs_cpu"] = [share(g, c) for g, c in zip(tr[("cuda", torch.float64)], c64)]
    res["train_f32_card_vs_cpu_f64"] = [share(g, c) for g, c in
                                        zip(tr[("cuda", torch.float32)], c64)]
    res["train_f32_cpu_vs_cpu_f64"] = [share(g, c) for g, c in zip(tr[("cpu", torch.float32)], c64)]
    res["train_f32_card_vs_cpu"] = [share(g, c) for g, c in zip(tr[("cuda", torch.float32)],
                                                                 tr[("cpu", torch.float32)])]
    torch.backends.cudnn.allow_tf32 = True
    print(f"6d zoo graph card vs cpu ({card}; 640 px, bs 2, tf32 off) " + json.dumps(res),
          flush=True)
    ok = len(eval_c) == 7 and max(res["eval_f32_card_vs_cpu"]) <= ZOO_6D_TOL \
        and max(res["train_f64_card_vs_cpu"]) <= ZOO_6D_F64_TOL \
        and max(res["train_f32_card_vs_cpu_f64"]) \
        <= 2 * max(res["train_f32_cpu_vs_cpu_f64"]) + ZOO_6D_TOL / 10
    if not ok:
        raise AssertionError(f"6d zoo graph, card vs CPU: {res}")
    return res


def tta_path(card: str) -> dict:
    """Phase 6h (c) and (d). (c) segment.val on phase 6b's seeded set (the
    same primed yolov5s-seg, its own boxes as labels) with --device-preprocess
    at bs 32, once with --augment, once with --soft-nms and once with both:
    K1 once a batch, whole-run img/s and the speed line, and the NMS ms of one
    bs-32 batch beside 6b's greedy nms_from_raw; card against CPU on
    EVAL_CHECK_FRAMES frames at bs 8, TF32 off, the 8 metrics within 0.01.
    (d) segment.predict --augment at batch 1 on TTA_PREDICT_FRAMES 480x640
    .npy frames: pre, infer and post ms, K1 once a frame. Returns the K1
    launches of (c) and of (d)."""
    import shutil
    import tempfile

    from yolo_dual_tpu_torch.data.dataset import YoloDataset
    from yolo_dual_tpu_torch.data.loader import Loader
    from yolo_dual_tpu_torch.engine.predictor import predict_images
    from yolo_dual_tpu_torch.engine.validator import PRE_NMS_TOPK, evaluate_segment
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel, forward_augment
    from yolo_dual_tpu_torch.ops import nms as nms_ops
    from yolo_dual_tpu_torch.segment import predict, val
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    frames = make_frames(EVAL_FRAMES, seed=5, sizes=(EVAL_SHAPE,))
    model = SegmentationModel("yolov5s-seg.json", device="cuda",
                              generator=torch.Generator().manual_seed(0))
    prime_for_eval(calibrate_bn(model, frames[:3]))
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tta_", dir=build))
    n_batches = -(-EVAL_FRAMES // EVAL_BS)
    out = {"card": card, "frames": EVAL_FRAMES, "bs": EVAL_BS, "runs": {}}
    failures = []
    try:
        root = write_val_set(tmp / "val", model, frames)
        weights = tmp / "yolov5s-seg-primed.pt"
        torch.save(model.state_dict(), weights)
        kw = dict(data=str(root), weights=str(weights), cfg="yolov5s-seg.json",
                  batch_size=EVAL_BS, imgsz=640, conf_thres=0.001, iou_thres=0.6, device="cuda",
                  device_preprocess=True)
        val_k1 = 0
        for name, flags in TTA_RUNS.items():
            letterbox_normalize.launches = 0
            val.run(**kw, **flags)  # warm-up run, counted
            n = letterbox_normalize.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, _, times = val.run(**kw, **flags)
            wall = time.perf_counter() - t0
            val_k1 += letterbox_normalize.launches
            out["runs"][name] = {
                "metrics": [float(v) for v in mean], "k1_launches_a_run": n,
                "speed_ms_per_image": dict(zip(("pre", "inference+nms", "post"), times)),
                "img_per_s_run": EVAL_FRAMES / wall}
            if n != n_batches or not (mean[2] > 0.05 and mean[6] > 0.05):
                failures.append(f"val {name}: {n} K1 launches for {n_batches} batches, "
                                f"metrics {mean}")

        # the inference + NMS of one bs-32 batch: greedy off the raw maps (6b's), soft
        model.eval().fuse()
        head = model.model[-1]
        x = letterbox_normalize(torch.from_numpy(np.stack(frames[:EVAL_BS])).cuda(), 640,
                                scaleup=False)
        kwn = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, max_det=300, nm=head.nm,
                   pre_nms_topk=PRE_NMS_TOPK)
        with torch.inference_mode():
            levels, _ = model(x, decode=False)
            pred, _ = forward_augment(model, x)
            ms = {"forward": cuda_ms(lambda: model(x, decode=False), 5),
                  "forward_augment": cuda_ms(lambda: forward_augment(model, x), 5),
                  "nms_from_raw_greedy": cuda_ms(lambda: nms_ops.nms_from_raw(
                      levels, head.anchors, head.strides, **kwn), 5),
                  "nms_from_raw_soft": cuda_ms(lambda: nms_ops.nms_from_raw(
                      levels, head.anchors, head.strides, use_soft_nms=True, **kwn), 3),
                  "nms_batched_tta_greedy": cuda_ms(lambda: nms_ops.nms_batched(pred, **kwn), 5),
                  "nms_batched_tta_soft": cuda_ms(lambda: nms_ops.nms_batched(
                      pred, use_soft_nms=True, **kwn), 3)}
        out["stage_bs32_ms"] = ms

        # card against CPU, TF32 off, 8 frames at bs 8
        torch.backends.cudnn.allow_tf32 = False
        sub = tmp / "val8"
        for d in ("images", "labels"):
            (sub / d).mkdir(parents=True)
            for f in sorted((root / d).iterdir())[:EVAL_CHECK_FRAMES]:
                shutil.copy(f, sub / d / f.name)
        for name, flags in TTA_RUNS.items():
            got = {}
            for dev in ("cuda", "cpu"):
                m = SegmentationModel("yolov5s-seg.json", device=dev)
                m.load_state_dict(torch.load(weights, map_location=dev, weights_only=True))
                loader = Loader(YoloDataset(str(sub / "images"), imgsz=640,
                                            device_preprocess=True), batch_size=8)
                got[dev] = np.asarray(evaluate_segment(
                    m, loader, 80, conf_thres=0.001, iou_thres=0.6, device=dev,
                    augment=flags.get("augment", False),
                    use_soft_nms=flags.get("soft_nms", False))[0], np.float64)
            diff = float(np.abs(got["cuda"] - got["cpu"]).max())
            out["runs"][name]["card_vs_cpu"] = {"card": got["cuda"].round(5).tolist(),
                                                "cpu": got["cpu"].round(5).tolist(),
                                                "max_abs_diff": diff}
            if not diff <= 0.01:
                failures.append(f"val {name} card vs CPU: {diff} > 0.01")
        torch.backends.cudnn.allow_tf32 = True

        # (d) segment.predict --augment at batch 1
        src = tmp / "predict"
        src.mkdir()
        for i, f in enumerate(make_frames(TTA_PREDICT_FRAMES, seed=11, sizes=(EVAL_SHAPE,))):
            np.save(src / f"{i:03d}.npy", f)
        letterbox_normalize.launches = 0
        dets = predict.run(weights=str(weights), source=str(src), nosave=True, augment=True,
                           conf_thres=0.25, device="cuda")
        pred_k1 = letterbox_normalize.launches
        prof = predict_images.profiles
        out["predict_augment_bs1"] = {
            "frames": TTA_PREDICT_FRAMES, "k1_launches": pred_k1,
            "rows": [len(d) for d in dets],
            "ms_per_frame": {k: p.t / TTA_PREDICT_FRAMES * 1e3
                             for k, p in zip(("pre", "infer", "post"), prof)}}
        if pred_k1 != TTA_PREDICT_FRAMES or len(dets) != TTA_PREDICT_FRAMES \
                or not all(np.isfinite(d).all() for d in dets):
            failures.append(f"predict --augment: {pred_k1} K1 launches, {len(dets)} frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("tta soft-nms (6h c, d) " + json.dumps(out), flush=True)
    del model
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("tta (6h c, d): " + "; ".join(failures))
    return {"val": val_k1, "predict": pred_k1}


# Phase 6i: the HTTP model server (serve.py) and its client (io/remote.py) on the card, and
# the prediction outputs: segment.predict's crops, feature maps and txt rows, segment.val
# --save-json
SERVE_SHAPES = {(480, 640): 24, (720, 1280): 8}  # the PNG requests of (a), RGB frames
SERVE_CONF = 0.25
SERVE_BOX_TOL = 1e-2   # px: a response against the direct card forward; --save-json card vs CPU
SERVE_CONF_TOL = 1e-4  # card vs CPU, TF32 off (phase 5's)
# card vs CPU, TF32 off, over the SERVE_CHECK requests: each of the CPU's rows is paired
# with a card row of its class within SERVE_BOX_TOL px and SERVE_CONF_TOL, or is a near tie
# (tests/detection_matching.py:pair_detections: NMS kept the other of two overlapping
# boxes of one class within 1e-4 in confidence), but for at most SERVE_LEFT_SHARE of them;
# each request's row count within SERVE_COUNT_SHARE of the CPU's (phase 5's). The primed
# DCNv3 model keeps 200-300 rows at conf 0.25 on dense 480x640 frames, where NMS swaps
# near-equal overlapping boxes and cascades (on an NVIDIA H100 80GB HBM3 at 700 W the card
# kept 84-100% of the CPU's rows a request by phase 5's IoU > 0.99 rule; PERF.md)
SERVE_LEFT_SHARE, SERVE_COUNT_SHARE = 0.01, 0.02
SERVE_CHECK = 8  # requests card against CPU
SERVE_SEM_FRAMES, SERVE_SEM_CHECK = 8, 2  # (b): 720x960 requests; of them card against CPU
SERVE_BURST = 8  # requests of the profiled burst (after phase 9)
PREDICT_OUT_FRAMES = 8  # (c): segment.predict's frames
JSON_CHECK_MAX_DET = 100  # (c): the 8-frame --save-json check card vs CPU; the CPU's mask chain
JSON_MASK_IOU = 0.99  # (c): an entry's mask card against CPU
M2S_MASKS = 200  # (c): masks timed through masks2segments


@contextlib.contextmanager
def serving(server):
    """`server` (serve.py:build_server) in a daemon thread; yields its URL, and
    shuts the server down and closes it on the way out."""
    import threading
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)


def post_json(url: str, body: bytes) -> dict:
    import urllib.request
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def percentiles(timings) -> dict:
    """p50 and p90 of each part (ms) of a list of per-request dicts."""
    return {k: {q: float(np.percentile([t[k] for t in timings], int(q[1:])))
                for q in ("p50", "p90")} for k in timings[0]}


def served_detections(model, frame_rgb: np.ndarray) -> np.ndarray:
    """What the server computes for one RGB frame, run directly on the model's
    device: host letterbox, the fused forward, nms_from_raw, scale_boxes.
    Rows [x1, y1, x2, y2, conf, cls] in the frame's pixels."""
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.ops.boxes import scale_boxes
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    head = model.model[-1]
    dev = next(model.parameters()).device
    im, _, _ = letterbox(frame_rgb, 640)
    with torch.inference_mode():
        x = torch.from_numpy(im).to(dev).permute(2, 0, 1)[None].float() / 255.0
        levels, _ = model(x, decode=False)
        out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=SERVE_CONF,
                               iou_thres=0.45, max_det=300, nm=head.nm)
        d = out[0, :int(nv[0])].cpu()
    boxes = scale_boxes((640, 640), d[:, :4], frame_rgb.shape[:2])
    return np.concatenate([boxes.numpy(), d[:, 4:6].numpy()], 1)


def served_class_map(model, frame_rgb: np.ndarray, scores_out: list = None) -> np.ndarray:
    """The semantic server's class map of one RGB frame, run directly: host
    letterbox, the fused forward, argmax, the content box cropped and resized
    (nearest) to the frame. With `scores_out`, the top-two gap of the scores,
    carried through the same crop and resize, is appended to it."""
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.data.json_dataset import resize_nearest_u8
    dev = next(model.parameters()).device
    h0, w0 = frame_rgb.shape[:2]
    im, ratio, pad = letterbox(frame_rgb, 640)
    with torch.inference_mode():
        s = model(torch.from_numpy(im).to(dev).permute(2, 0, 1)[None].float() / 255.0)[0]
        cmap = s.argmax(0).to(torch.uint8).cpu().numpy()
        top2 = s.topk(2, dim=0).values.float().cpu().numpy()
    bw, bh = int(round(w0 * ratio[0])), int(round(h0 * ratio[1]))
    top, left = int(round(pad[1] - 0.1)), int(round(pad[0] - 0.1))

    def fit(a):
        return resize_nearest_u8(a[top:top + bh, left:left + bw], h0, w0)
    if scores_out is not None:
        scores_out.append(fit(top2[0] - top2[1]))
    return fit(cmap)


def min_box_gap(want: np.ndarray, got: np.ndarray) -> float:
    """Largest, over the rows of `want`, of the smallest corner gap (px) to a
    row of `got` of the same class."""
    gaps = [np.abs(got[got[:, 5] == r[5], :4] - r[:4]).max(1, initial=0.0).min(initial=np.inf)
            for r in want]
    return float(max(gaps, default=0.0))


def serve_detect(card: str, tmp: Path) -> dict:
    """Phase 6i (a): yolov5s-seg-dcnv3 (full width and depth, the DCNv3 heads
    drawn and BatchNorm calibrated as phase 4's, primed as phase 6b's so it
    detects at conf 0.25) written as a .pt and served by serve.py on the card;
    32 PNG requests through RemoteModel, each against the direct card
    computation; K2 launches; parts and requests/s; 8 requests card against
    a CPU server, TF32 off."""
    from detection_matching import match_detections, pair_detections
    from yolo_dual_tpu_torch import serve
    from yolo_dual_tpu_torch.io.remote import RemoteModel
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.utils import png
    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(0)
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda", generator=gen)
    draw_dcnv3_heads(model, gen)
    prime_for_eval(calibrate_bn(model, make_frames(3, seed=1)))
    weights = tmp / "yolov5s-seg-dcnv3-primed.pt"
    torch.save(model.state_dict(), weights)
    del model
    frames = [f for shape, n in SERVE_SHAPES.items() for f in make_frames(n, seed=41 + n,
                                                                          sizes=(shape,))]
    t0 = time.perf_counter()
    bodies = [png.encode(f[..., ::-1]) for f in frames]  # the client's PNG of each BGR frame
    encode_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    argv = ["--weights", str(weights), "--cfg", "yolov5s-seg-dcnv3.json", "--port", "0",
            "--conf-thres", str(SERVE_CONF)]
    dcnv3_sampling.launches = letterbox_normalize.launches = 0
    server = serve.build_server(serve.parse_opt(argv + ["--device", "cuda"]))
    with serving(server) as url:
        client = RemoteModel(url, timeout=120)
        got, per_request = [], []
        t0 = time.perf_counter()
        for body in bodies:
            t1 = time.perf_counter()
            got.append(client(body))
            per_request.append((time.perf_counter() - t1) * 1e3)
        serial_s = time.perf_counter() - t0
        launches = {"dcnv3_sampling": dcnv3_sampling.launches,
                    "letterbox_normalize": letterbox_normalize.launches}
        n_dcn = sum(DCN_PATH_SHAPES.values())
        want_launches = {"dcnv3_sampling": n_dcn * (len(frames) + 1), "letterbox_normalize": 0}
        direct = [served_detections(server.model, f) for f in frames]
        array_reply = client(frames[0][..., ::-1])  # an array, encoded by the client
        failures = []
        for i, (g, d) in enumerate(zip(got, direct)):
            if len(g) != len(d) or (len(d) and (np.abs(g[:, :4] - d[:, :4]).max() > SERVE_BOX_TOL
                                                or (g[:, 5] != d[:, 5]).any())):
                failures.append(f"request {i}: {len(g)} rows against the direct {len(d)}")
        if not np.array_equal(array_reply, got[0]):
            failures.append("an array request differs from its PNG bytes' request")
        # the codec's two decode paths on a 720x1280 frame: Sub rows (the port's encoder)
        # a row at a time, Paeth rows (libpng writes some) along anti-diagonals
        decode_ms = {}
        for kind in ("sub", "paeth"):
            buf = png.encode(frames[-1][..., ::-1], filter_type=kind)
            decode_ms[kind] = host_ms(lambda: png.decode(buf), iters=3)
            if not np.array_equal(png.decode(buf), frames[-1][..., ::-1]):
                failures.append(f"PNG {kind} rows decode to another frame")
        # card against CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        check = list(range(SERVE_CHECK // 2)) + list(range(len(frames) - SERVE_CHECK // 2,
                                                           len(frames)))
        cpu_server = serve.build_server(serve.parse_opt(argv + ["--device", "cpu"]))
        with serving(cpu_server) as cpu_url:
            cpu_client = RemoteModel(cpu_url, timeout=300)
            pairs, matched = [], 0.0
            for i in check:
                c, g = cpu_client(bodies[i]), client(bodies[i])
                n, ties, left_c, left_g = pair_detections(c, g, SERVE_CONF, box_tol=SERVE_BOX_TOL,
                                                          conf_tol=SERVE_CONF_TOL)
                share = match_detections(c, g)
                matched += share * len(c)
                pairs.append({"rows": [len(g), len(c)], "match_share": share,
                              "paired_within_1e-2_px": n, "near_ties": ties,
                              "left": [len(left_g), len(left_c)], "box_gap_px": min_box_gap(c, g)})
                if abs(len(g) - len(c)) > SERVE_COUNT_SHARE * len(c):
                    failures.append(f"request {i} card vs CPU: {len(g)} rows against {len(c)}")
            n_cpu = max(sum(p["rows"][1] for p in pairs), 1)
            pooled = matched / n_cpu
            left_share = sum(p["left"][1] for p in pairs) / n_cpu
            if left_share > SERVE_LEFT_SHARE:
                failures.append(f"card vs CPU: {left_share} of the CPU's rows neither paired "
                                f"nor near ties > {SERVE_LEFT_SHARE}")
        torch.backends.cudnn.allow_tf32 = True
    timings = server.timings[:len(frames)]
    out = {"card": card, "requests": {f"{h}x{w}": n for (h, w), n in SERVE_SHAPES.items()},
           "launches": launches, "rows_per_request": [len(g) for g in got],
           "max_box_gap_px_vs_direct": max((float(np.abs(g[:, :4] - d[:, :4]).max())
                                            for g, d in zip(got, direct) if len(d) == len(g)
                                            and len(d)), default=0.0),
           "server_parts_ms": percentiles(timings),
           "decode_share_p50": float(np.median([t["decode"] / sum(
               v for k, v in t.items() if k != "device_events_ms") for t in timings])),
           "client_request_ms": percentiles([{"request": t} for t in per_request])["request"],
           "client_png_encode_ms_per_frame": encode_ms,
           "png_decode_ms_720x1280": decode_ms,
           "requests_per_s_serial_client": len(frames) / serial_s,
           "card_vs_cpu_tf32_off": pairs, "card_vs_cpu_match_share_pooled": pooled,
           "card_vs_cpu_left_share": left_share}
    print("serve detect (6i a) " + json.dumps(out), flush=True)
    if launches != want_launches:
        failures.append(f"launches {launches}, expected {want_launches}")
    if not sum(len(g) for g in got):
        failures.append("no detections at conf 0.25")
    if failures:
        raise AssertionError("serve detect (6i a): " + "; ".join(failures))
    return {"launches": launches, "weights": weights, "bodies": bodies[:SERVE_BURST],
            "argv": argv}


def serve_semantic(card: str, tmp: Path) -> dict:
    """Phase 6i (b): resnet50.json (nc 12, full width and depth, BatchNorm
    calibrated as phase 6c's) served on the card; 8 PNG requests of CamVid-style
    720x960 frames against the direct card computation (shape, class_pixels,
    the decoded class-map PNG, all equal); 2 of them card against a CPU
    server, TF32 off: argmax flips only at near ties of the CPU's scores."""
    from yolo_dual_tpu_torch import serve
    from yolo_dual_tpu_torch.models.model import SemanticSegModel
    from yolo_dual_tpu_torch.utils import png
    img_dir, _ = write_semantic_set(tmp / "camvid", SERVE_SEM_FRAMES, seed=31)
    frames = [np.load(f) for f in sorted(img_dir.glob("*.npy"))]
    model = SemanticSegModel("resnet50.json", device="cuda",
                             generator=torch.Generator().manual_seed(0))
    calibrate_bn(model, frames[:4], fill=128.0)
    weights = tmp / "resnet50-calibrated.pt"
    torch.save(model.state_dict(), weights)
    del model
    bodies = [png.encode(f[..., ::-1]) for f in frames]
    argv = ["--weights", str(weights), "--cfg", "resnet50.json", "--port", "0"]
    failures, flips = [], []
    server = serve.build_server(serve.parse_opt(argv + ["--device", "cuda"]))
    with serving(server) as url:
        replies = [post_json(url, b) for b in bodies]
        for i, (r, f) in enumerate(zip(replies, frames)):
            want = served_class_map(server.model, f)
            ids, counts = np.unique(want, return_counts=True)
            got_map = png.decode(base64.b64decode(r["mask_png_b64"]))
            if r["shape"] != list(f.shape[:2]) or not np.array_equal(got_map, want) or \
                    r["class_pixels"] != {str(int(k)): int(c) for k, c in zip(ids, counts)}:
                failures.append(f"request {i}: the reply differs from the direct card map")
        torch.backends.cudnn.allow_tf32 = False
        cpu_server = serve.build_server(serve.parse_opt(argv + ["--device", "cpu"]))
        with serving(cpu_server) as cpu_url:
            for i in range(SERVE_SEM_CHECK):
                gaps = []
                served_class_map(cpu_server.model, frames[i], gaps)
                c = png.decode(base64.b64decode(post_json(cpu_url, bodies[i])["mask_png_b64"]))
                g = png.decode(base64.b64decode(post_json(url, bodies[i])["mask_png_b64"]))
                flip = g != c
                largest = float(gaps[0][flip].max()) if flip.any() else 0.0
                flips.append({"flips": int(flip.sum()), "share": float(flip.mean()),
                              "largest_cpu_gap_of_a_flip": largest})
                if flip.mean() > SEM_FLIP_SHARE or largest > SEM_NEAR_TIE:
                    failures.append(f"request {i} card vs CPU: {flips[-1]}")
        torch.backends.cudnn.allow_tf32 = True
    out = {"card": card, "requests": SERVE_SEM_FRAMES, "shape": list(SEM_SHAPE),
           "classes_per_reply": [len(r["class_pixels"]) for r in replies],
           "server_parts_ms": percentiles(server.timings[:SERVE_SEM_FRAMES]),
           "card_vs_cpu_tf32_off": flips}
    print("serve semantic (6i b) " + json.dumps(out), flush=True)
    if min(out["classes_per_reply"]) < 2:
        failures.append(f"degenerate class maps: {out['classes_per_reply']}")
    if failures:
        raise AssertionError("serve semantic (6i b): " + "; ".join(failures))
    return out


def json_entry_pairs(cpu: list, card: list) -> dict:
    """Pair two runs' predictions.json entries of one set: the same image and
    category, scores within SERVE_CONF_TOL, bbox corners within SERVE_BOX_TOL
    px. An entry left unpaired is a near tie when an unpaired entry of the
    other run in its image has its category and a score within
    SERVE_CONF_TOL, or when its score lies within SERVE_CONF_TOL of the
    lowest kept score of its image (the max_det cut). Returns the counts, the
    masks' smallest IoU over the pairs and the entries left."""
    from yolo_dual_tpu_torch.utils.coco import rle_to_binary_mask
    by_image = {}
    for j, e in enumerate(card):
        by_image.setdefault(e["image_id"], []).append(j)
    used, left_cpu, ious = set(), [], []
    for e in cpu:
        hit = [j for j in by_image.get(e["image_id"], []) if j not in used
               and card[j]["category_id"] == e["category_id"]
               and abs(card[j]["score"] - e["score"]) <= SERVE_CONF_TOL
               and np.abs(np.subtract(card[j]["bbox"], e["bbox"])).max() <= SERVE_BOX_TOL]
        if not hit:
            left_cpu.append(e)
            continue
        used.add(hit[0])
        a, b = (rle_to_binary_mask(x["segmentation"]).astype(bool)
                for x in (e, card[hit[0]]))
        union = (a | b).sum()
        ious.append(float((a & b).sum() / union) if union else 1.0)
    left_card = [card[j] for j in range(len(card)) if j not in used]
    lowest = {}
    for e in cpu + card:
        lowest[e["image_id"]] = min(lowest.get(e["image_id"], 1.0), e["score"])

    def tie(e, others):
        return abs(e["score"] - lowest[e["image_id"]]) <= SERVE_CONF_TOL or any(
            o["image_id"] == e["image_id"] and o["category_id"] == e["category_id"]
            and abs(o["score"] - e["score"]) <= SERVE_CONF_TOL for o in others)
    bad = [e for e in left_cpu if not tie(e, left_card)] + \
        [e for e in left_card if not tie(e, left_cpu)]
    return {"entries": [len(cpu), len(card)], "paired": len(ious),
            "near_ties": len(left_cpu) + len(left_card) - len(bad), "unexplained": len(bad),
            "min_mask_iou": min(ious, default=1.0)}


def predict_outputs(card: str, tmp: Path) -> dict:
    """Phase 6i (c): the primed yolov5s-seg of phase 6b (as a .pt) through
    segment.predict on PREDICT_OUT_FRAMES `.npy` 480x640 frames with
    --save-txt --save-crop --visualize --retina-masks --data (names): a crop a
    kept detection, a feature map a layer with a 4-D output, the txt rows, K1
    a frame (crops and maps are `.npy` where cv2 and matplotlib are missing;
    `host_packages` says which); then segment.val --save-json on phase 6b's 64-frame set: an entry
    a kept detection (against the validator's own NMS run directly), every
    RLE a mask of its frame's size, 8 frames card against CPU (TF32 off,
    max_det JSON_CHECK_MAX_DET), COCOeval None without pycocotools;
    masks2segments and the JSON writer timed."""
    import shutil

    from yolo_dual_tpu_torch.engine.validator import PRE_NMS_TOPK
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.ops.mask_ops import masks2segments
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    from yolo_dual_tpu_torch.segment import predict, val
    from yolo_dual_tpu_torch.utils.coco import evaluate_coco_json, rle_to_binary_mask
    import importlib.util
    torch.backends.cudnn.allow_tf32 = True
    frames = make_frames(EVAL_FRAMES, seed=5, sizes=(EVAL_SHAPE,))
    model = SegmentationModel("yolov5s-seg.json", device="cuda",
                              generator=torch.Generator().manual_seed(0))
    prime_for_eval(calibrate_bn(model, frames[:3]))
    weights = tmp / "yolov5s-seg-primed.pt"
    torch.save(model.state_dict(), weights)
    # which outputs take the package's format (.jpg / .png) and which the .npy fallback
    failures, out = [], {"card": card, "host_packages": {
        m: importlib.util.find_spec(m) is not None for m in ("cv2", "matplotlib", "mss",
                                                              "pycocotools")}}

    # segment.predict with every output
    src = tmp / "predict_src"
    src.mkdir()
    for i, f in enumerate(frames[:PREDICT_OUT_FRAMES]):
        np.save(src / f"{i:03d}.npy", f)
    data = tmp / "names.json"
    data.write_text(json.dumps({"nc": 80, "names": [f"class{i}" for i in range(80)]}))
    letterbox_normalize.launches = 0
    t0 = time.perf_counter()
    dets = predict.run(weights=str(weights), source=str(src), data=str(data), save_txt=True,
                       save_crop=True, visualize=True, retina_masks=True, nosave=True,
                       project=str(tmp), name="predict", device="cuda")
    predict_s = time.perf_counter() - t0
    k1_predict = letterbox_normalize.launches
    run = tmp / "predict"
    crops = sorted((run / "crops").rglob("*"))
    crops = [c for c in crops if c.is_file()]
    fused = SegmentationModel("yolov5s-seg.json", device="cuda")
    fused.load_state_dict(torch.load(weights, map_location="cuda", weights_only=True))
    fused.eval().fuse()
    four_d = []
    hooks = [m.register_forward_hook(lambda mod, i, o, k=k: four_d.append(k) if isinstance(
        o, torch.Tensor) and o.ndim == 4 else None) for k, m in enumerate(fused.model)]
    with torch.inference_mode():
        fused(letterbox_normalize(torch.from_numpy(frames[0])[None].cuda(), 640))
    for hk in hooks:
        hk.remove()
    features = sorted((run / "features").glob("*"))
    txt_rows = {p.stem: len(p.read_text().splitlines()) for p in (run / "labels").glob("*.txt")}
    want_rows = {f"{i:03d}": len(d) for i, d in enumerate(dets) if len(d)}
    out["predict"] = {"frames": PREDICT_OUT_FRAMES, "k1_launches": k1_predict,
                      "rows": [len(d) for d in dets], "crops": len(crops),
                      "crop_suffixes": sorted({c.suffix for c in crops}),
                      "feature_files": len(features), "layers_with_4d_output": len(four_d),
                      "feature_suffixes": sorted({f.suffix for f in features}),
                      "run_s": predict_s}
    if k1_predict != PREDICT_OUT_FRAMES or len(crops) != sum(len(d) for d in dets) \
            or not len(crops) or len(features) != len(four_d) or txt_rows != want_rows:
        failures.append(f"predict outputs: {out['predict']}, txt rows {txt_rows} against "
                        f"{want_rows}")

    # segment.val --save-json on phase 6b's set (labelled again, as 6b labels it)
    root = write_val_set(tmp / "val", model, frames)
    kw = dict(data=str(root), weights=str(weights), cfg="yolov5s-seg.json", batch_size=EVAL_BS,
              imgsz=640, conf_thres=0.001, iou_thres=0.6, device_preprocess=True,
              project=str(tmp), exist_ok=True)
    letterbox_normalize.launches = 0
    t0 = time.perf_counter()
    mean, _, times = val.run(save_json=True, name="json", device="cuda", **kw)
    json_run_s = time.perf_counter() - t0
    k1_val = letterbox_normalize.launches
    _, _, times_plain = val.run(name="plain", device="cuda", **kw)
    entries = json.loads((tmp / "json" / "predictions.json").read_text())
    kept = {}
    with torch.inference_mode():
        for i in range(0, EVAL_FRAMES, EVAL_BS):
            x = letterbox_normalize(torch.from_numpy(np.stack(frames[i:i + EVAL_BS])).cuda(),
                                    640, scaleup=False)
            levels, _ = fused(x, decode=False)
            head = fused.model[-1]
            _, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=0.001,
                                 iou_thres=0.6, multi_label=True, max_det=300, nm=head.nm,
                                 pre_nms_topk=PRE_NMS_TOPK)
            kept.update({i + j: n for j, n in enumerate(nv.tolist()) if n})
    per_image = {}
    for e in entries:
        per_image[int(e["image_id"])] = per_image.get(int(e["image_id"]), 0) + 1
    masks = [rle_to_binary_mask(e["segmentation"]) for e in entries[:M2S_MASKS]]
    sizes_ok = all(e["segmentation"]["size"] == list(EVAL_SHAPE) for e in entries) and all(
        m.shape == EVAL_SHAPE for m in masks)
    t0 = time.perf_counter()
    segments = masks2segments(np.stack(masks))
    m2s_ms = (time.perf_counter() - t0) / len(masks) * 1e3
    coco_eval = evaluate_coco_json(tmp / "json" / "predictions.json", root / "instances.json")
    out["save_json"] = {
        "frames": EVAL_FRAMES, "entries": len(entries), "k1_launches": k1_val,
        "metrics": [float(v) for v in mean], "run_s": json_run_s,
        "post_ms_per_image": {"save_json": times[2], "plain": times_plain[2]},
        "json_writer_ms_per_batch": (times[2] - times_plain[2]) * EVAL_BS,
        "masks2segments_ms_per_mask": m2s_ms, "masks_timed": len(masks),
        "points_per_segment_mean": float(np.mean([len(s) for s in segments])),
        "coco_eval": coco_eval}
    if per_image != kept or not sizes_ok or coco_eval is not None or \
            k1_val != -(-EVAL_FRAMES // EVAL_BS):
        failures.append(f"--save-json: entries a frame {per_image} against the kept rows "
                        f"{kept}, sizes ok {sizes_ok}, COCOeval {coco_eval}, K1 {k1_val}")

    # 8 frames card against CPU, TF32 off
    sub = tmp / "val8"
    for d in ("images", "labels"):
        (sub / d).mkdir(parents=True)
        for f in sorted((root / d).iterdir())[:EVAL_CHECK_FRAMES]:
            shutil.copy(f, sub / d / f.name)
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for dev in ("cuda", "cpu"):
        val.run(**{**kw, "data": str(sub), "batch_size": EVAL_CHECK_FRAMES,
                   "max_det": JSON_CHECK_MAX_DET, "save_json": True, "name": f"json8_{dev}",
                   "device": dev})
        runs[dev] = json.loads((tmp / f"json8_{dev}" / "predictions.json").read_text())
    torch.backends.cudnn.allow_tf32 = True
    out["card_vs_cpu_8_frames_tf32_off"] = check = json_entry_pairs(runs["cpu"], runs["cuda"])
    print("predict outputs and --save-json (6i c) " + json.dumps(out), flush=True)
    if check["unexplained"] or check["min_mask_iou"] < JSON_MASK_IOU or not check["paired"]:
        failures.append(f"--save-json card vs CPU: {check}")
    del model, fused
    if failures:
        raise AssertionError("predict outputs (6i c): " + "; ".join(failures))
    return {"predict": k1_predict, "val": k1_val}


def serve_path(card: str):
    """Phase 6i: (a) serve_detect, (b) serve_semantic, (c) predict_outputs,
    under build/phase6i. Returns the launches of (a) and (c) and a function
    that profiles a burst of SERVE_BURST requests to a fresh detection server
    (after phase 9, as the other profiles) and then removes the phase's files."""
    import shutil
    from yolo_dual_tpu_torch import serve
    from yolo_dual_tpu_torch.io.remote import RemoteModel
    t_phase = time.perf_counter()
    tmp = Path(__file__).resolve().parent / "build" / "phase6i"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        det = serve_detect(card, tmp)
        serve_semantic(card, tmp)
        k1 = predict_outputs(card, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    torch.cuda.empty_cache()
    print(f"phase 6i s {time.perf_counter() - t_phase:.2f}", flush=True)

    def profile():
        """The card's busy share of a burst of SERVE_BURST requests from one
        serial client (torch.profiler device time over the burst's wall)."""
        from torch.profiler import ProfilerActivity, profile as torch_profile
        try:
            server = serve.build_server(serve.parse_opt(det["argv"] + ["--device", "cuda"]))
            with serving(server) as url:
                client = RemoteModel(url, timeout=120)
                client(det["bodies"][0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    for body in det["bodies"]:
                        client(body)
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
        return {"card": card, "requests": len(det["bodies"]), "burst_wall_ms": wall_ms,
                "device_ms": device_ms if device_ms else "not measured",
                "busy_share": device_ms / wall_ms if device_ms else "not measured",
                "top_ms": [[e.key[:80], round(e.self_device_time_total / 1e3, 3), e.count]
                           for e in top]}
    return det["launches"], k1, profile


# Phase 6j: weights in and out. The port's export, MultiBackend and Ensemble on the full-width
# yolov5s-seg-dcnv3 (K2); the JAX package's orbax checkpoint (tests/data/torch_port_orbax,
# written by JAX's save_checkpoint) read and served without JAX; an ONNX file in cv2.dnn
ORBAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "torch_port_orbax"
WEIGHTS_BS = 8
# (a) MultiBackend and Ensemble against the direct card forwards of the same weights: the
# same computation on the same card, held within SAME_TOL of the largest magnitude
SAME_TOL = 1e-5
# (b) the fixture served on the card, TF32 off, against JAX's float32 CPU output (JAX's
# MultiBackend, matmuls at "highest"): rtol and atol 1e-4, the float32 gap of two summation
# orders over the nano graph that tests/test_torch_port_dcn.py holds the port's CPU forward
# to, and that the port's CPU run of this fixture keeps (9.2e-5 at most, on a |pred| of 434)
FIXTURE_TOL = 1e-4
# (c) cv2.dnn against the port's card forward, TF32 off: tests/test_onnx_export.py's limits
ONNX_PRED_TOL, ONNX_PROTOS_TOL = dict(atol=2e-3, rtol=1e-3), dict(atol=1e-3, rtol=1e-3)


def max_rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def primed_dcnv3(seed: int):
    """yolov5s-seg-dcnv3 on the card as phase 6i serves it: seeded weights, the
    DCNv3 heads drawn, BatchNorm calibrated on three frames, primed."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    gen = torch.Generator().manual_seed(seed)
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda", generator=gen)
    draw_dcnv3_heads(model, gen)
    return prime_for_eval(calibrate_bn(model, make_frames(3, seed=1 + seed)))


def weights_path(card: str) -> dict:
    """Phase 6j, under build/phase6j: (a) the primed yolov5s-seg-dcnv3 and a
    second seeded member written by export.py --include torchpt, MultiBackend
    of the first and Ensemble of both (cat, mean) on a bs-8 640-px batch
    against the models' own card forwards; (b) the orbax fixture read with no
    JAX, orbax or tensorstore imported and served by MultiBackend on the card;
    (c) yolov5s-seg (nc 80, fused) exported to ONNX at 640 and run by cv2.dnn
    against the card forward. The K2 count is set to 0 just before the
    MultiBackend and Ensemble forwards of (a) and (b) and read just after.
    Returns {kernel: launches}."""
    import shutil
    from yolo_dual_tpu_torch import export
    from yolo_dual_tpu_torch.io.ensemble import attempt_load
    from yolo_dual_tpu_torch.io.multibackend import MultiBackend
    from yolo_dual_tpu_torch.io.onnx_export import export_onnx
    from yolo_dual_tpu_torch.io.weights import resolve_state_dict
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    t_phase = time.perf_counter()
    tmp = Path(__file__).resolve().parent / "build" / "phase6j"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cfg = "yolov5s-seg-dcnv3.json"
    failures, out = [], {"card": card}
    try:
        # (a) two members, their own card forwards (unfused, as attempt_load leaves them),
        # then the first folded, as MultiBackend serves it
        torch.backends.cudnn.allow_tf32 = True
        x = torch.cat([letterbox_normalize(torch.from_numpy(f)[None].cuda(), 640)
                       for f in make_frames(WEIGHTS_BS, seed=61, sizes=((480, 640),))])
        members = [primed_dcnv3(0), primed_dcnv3(1)]
        for i, m in enumerate(members):
            torch.save(m.state_dict(), tmp / f"member{i}.pt")
        with torch.inference_mode():
            own = [m(x)[:2] for m in members]
            direct = members[0].fuse()(x)[:2]
        t0 = time.perf_counter()
        exported = export.run(weights=str(tmp / "member0.pt"), cfg=cfg, imgsz=640,
                              out_dir=str(tmp / "export"))["torchpt"]
        out["export_torchpt_ms"] = (time.perf_counter() - t0) * 1e3
        sources = [exported, tmp / "member1.pt"]
        # (b) the fixture: read without JAX, then served
        t0 = time.perf_counter()
        fixture_sd = resolve_state_dict(ORBAX_FIXTURE / "ckpt")
        out["fixture_read_ms"] = (time.perf_counter() - t0) * 1e3
        out["fixture_tensors"] = len(fixture_sd)
        foreign = sorted({m.split(".")[0] for m in sys.modules}
                         & {"jax", "jaxlib", "flax", "orbax", "tensorstore", "yolo_dual_tpu"})
        if foreign:
            failures.append(f"reading the orbax fixture imported {foreign}")
        fx = torch.from_numpy(np.load(ORBAX_FIXTURE / "input.npy")).cuda().permute(0, 3, 1, 2) \
            .float() / 255

        # the main path, counted: MultiBackend (a), Ensemble cat and mean (a), the fixture (b)
        dcnv3_sampling.launches = letterbox_normalize.launches = 0
        mb = MultiBackend(exported, cfg=cfg, nc=80, imgsz=640, device="cuda")
        pred, protos = mb(x)
        merged = {}
        for mode in ("cat", "mean"):
            ens = attempt_load([str(s) for s in sources], cfg, nc=80, mode=mode, device="cuda")
            merged[mode] = ens(x)
        torch.backends.cudnn.allow_tf32 = False
        fmb = MultiBackend(ORBAX_FIXTURE / "ckpt", cfg=ORBAX_FIXTURE / "cfg.json", nc=80,
                           imgsz=64, device="cuda")
        fpred, fprotos = fmb(fx)
        torch.cuda.synchronize()
        launches = {"dcnv3_sampling": dcnv3_sampling.launches,
                    "letterbox_normalize": letterbox_normalize.launches}
        per_fwd = {k: sum(isinstance(m, DCNv3) for m in model.modules())
                   for k, model in (("full", mb.model), ("fixture", fmb.model))}
        want_k2 = per_fwd["full"] * (1 + 2 * 2) + per_fwd["fixture"]
        if launches != {"dcnv3_sampling": want_k2, "letterbox_normalize": 0}:
            failures.append(f"launches {launches}, expected K2 {want_k2} "
                            f"({per_fwd} DCNv3 calls a forward) and no K1")
        out["launches"] = launches

        # (a) against the direct forwards
        gaps = {"multibackend_pred": max_rel_gap(pred, direct[0]),
                "multibackend_protos": max_rel_gap(protos, direct[1]),
                "cat_pred": max_rel_gap(merged["cat"][0], torch.cat([o[0] for o in own], 1)),
                "mean_pred": max_rel_gap(merged["mean"][0], (own[0][0] + own[1][0]) / 2),
                "cat_protos": max_rel_gap(merged["cat"][1], own[0][1]),
                "mean_protos": max_rel_gap(merged["mean"][1], own[0][1])}
        out["max_rel_gap_vs_direct"] = gaps
        failures += [f"(a) {k}: {v} > {SAME_TOL}" for k, v in gaps.items() if not v <= SAME_TOL]
        if merged["cat"][0].shape[1] != 2 * pred.shape[1] or pred.shape[0] != WEIGHTS_BS:
            failures.append(f"(a) shapes {list(pred.shape)}, cat {list(merged['cat'][0].shape)}")
        out["multibackend_ms_bs8"] = cuda_ms(lambda: mb(x), 10)
        with torch.inference_mode():
            out["direct_forward_ms_bs8"] = cuda_ms(lambda: members[0](x), 10)
        out["ensemble_mean_ms_bs8"] = cuda_ms(lambda: ens(x), 5)  # the last built: mean
        del members, own, direct, mb, ens, merged

        # (b) against JAX's saved output, TF32 off
        fwant = (np.load(ORBAX_FIXTURE / "pred.npy"), np.load(ORBAX_FIXTURE / "protos.npy"))
        fgot = (fpred.cpu().numpy(), fprotos.permute(0, 2, 3, 1).cpu().numpy())
        out["fixture_max_abs_err"] = [float(np.abs(g - w).max()) for g, w in zip(fgot, fwant)]
        for name, g, w in zip(("pred", "protos"), fgot, fwant):
            if g.shape != w.shape or not np.allclose(g, w, rtol=FIXTURE_TOL, atol=FIXTURE_TOL):
                failures.append(f"(b) fixture {name} against JAX's output: max abs "
                                f"{float(np.abs(g - w).max()) if g.shape == w.shape else g.shape}")
        out["fixture_multibackend_ms"] = cuda_ms(lambda: fmb(fx), 10)

        # (c) ONNX at full width: export, cv2.dnn on the host, the card forward, TF32 off
        import cv2
        gen = torch.Generator().manual_seed(2)
        model = calibrate_bn(SegmentationModel("yolov5s-seg.json", device="cuda", generator=gen),
                             make_frames(3, seed=3))
        t0 = time.perf_counter()
        onnx_file = export_onnx(model, 640, tmp / "yolov5s-seg.onnx")
        out["export_onnx_ms"] = (time.perf_counter() - t0) * 1e3
        out["onnx_mb"] = onnx_file.stat().st_size / 2 ** 20
        net = cv2.dnn.readNetFromONNX(str(onnx_file))
        x1 = x[:1]
        net.setInput(x1.cpu().numpy(), "images")
        got = net.forward(["pred", "protos"])
        out["cv2_dnn_forward_ms"] = host_ms(lambda: (net.setInput(x1.cpu().numpy(), "images"),
                                                     net.forward(["pred", "protos"])), iters=3)
        with torch.inference_mode():
            want = [t.cpu().numpy() for t in model.fuse()(x1)[:2]]
        torch.backends.cudnn.allow_tf32 = True
        out["onnx_max_abs_err"] = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
        for name, g, w, tol in (("pred", got[0], want[0], ONNX_PRED_TOL),
                                ("protos", got[1], want[1], ONNX_PROTOS_TOL)):
            if g.shape != w.shape or not np.allclose(g, w, **tol):
                failures.append(f"(c) cv2.dnn {name} against the card forward")
        out["cv2_version"] = cv2.__version__
    finally:
        torch.backends.cudnn.allow_tf32 = True
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_6j_s"] = time.perf_counter() - t_phase
    print("weights in and out (6j) " + json.dumps(out), flush=True)
    print(f"phase 6j s {out['phase_6j_s']:.2f}", flush=True)
    if failures:
        raise AssertionError("weights in and out (6j): " + "; ".join(failures))
    return launches


def dir_mb(path: Path) -> float:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file()) / 2 ** 20


def weights_out_path(card: str) -> dict:
    """Phase 6l, under build/phase6l: (a) a copy of the JAX package's orbax
    fixture stripped by train/checkpoint.py:strip_optimizer through the
    port's orbax writer (io/ocdbt.py), read back, served by MultiBackend on
    the card against the unstripped checkpoint's EMA forward, and
    segment.predict --update run on another copy; (b) yolov5s-seg (nc 80,
    640, seeded, BatchNorm calibrated) exported to a SavedModel, a float
    TFLite and an int8 TFLite file calibrated on JAX's 16 default frames on
    the card, the lowered graph run on the card against the model's float32
    and float64 forwards.
    The K2 and K1 counts are set to 0 just before (a)'s forwards and read
    just after. Returns {kernel: launches}."""
    import shutil
    from yolo_dual_tpu_torch import export
    from yolo_dual_tpu_torch.io import ocdbt
    from yolo_dual_tpu_torch.io.multibackend import MultiBackend
    from yolo_dual_tpu_torch.io.tf_graph import build_tf_graph, run_tf_graph
    from yolo_dual_tpu_torch.io.weights import resolve_state_dict
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling
    from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.nn.dcn import DCNv3
    from yolo_dual_tpu_torch.segment.predict import run as predict_run
    from yolo_dual_tpu_torch.train.checkpoint import strip_optimizer
    t_phase = time.perf_counter()
    tmp = Path(__file__).resolve().parent / "build" / "phase6l"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    failures, out = [], {"card": card}
    try:
        # (a) strip through the port's writer, read back, serve, --update
        for name in ("stripped", "update"):
            shutil.copytree(ORBAX_FIXTURE / "ckpt", tmp / name)
        t0 = time.perf_counter()
        strip_optimizer(tmp / "stripped")
        out["strip_write_ms"] = (time.perf_counter() - t0) * 1e3
        out["stripped_mb"] = dir_mb(tmp / "stripped")
        tree = ocdbt.load_checkpoint(tmp / "stripped")
        if (tree["opt_state"], tree["ema"], tree["epoch"]) != (None, None, -1):
            failures.append("(a) the stripped tree keeps its optimizer state, EMA or epoch")
        want_sd = resolve_state_dict(ORBAX_FIXTURE / "ckpt")       # the EMA first
        got_sd = resolve_state_dict(tmp / "stripped")
        if set(got_sd) != set(want_sd) or any(not torch.equal(got_sd[k], want_sd[k])
                                              for k in want_sd):
            failures.append("(a) the stripped variables are not the fixture's EMA")
        fx = torch.from_numpy(np.load(ORBAX_FIXTURE / "input.npy")).cuda().permute(0, 3, 1, 2) \
            .float() / 255
        frame = tmp / "frame.npy"
        np.save(frame, np.load(ORBAX_FIXTURE / "input.npy")[0])
        torch.backends.cudnn.allow_tf32 = False
        kw = dict(cfg=ORBAX_FIXTURE / "cfg.json", nc=80, imgsz=64, device="cuda")
        ref = MultiBackend(ORBAX_FIXTURE / "ckpt", **kw)
        want = ref(fx)
        torch.cuda.synchronize()

        # the main path, counted: the stripped checkpoint served, segment.predict --update
        dcnv3_sampling.launches = letterbox_normalize.launches = 0
        mb = MultiBackend(tmp / "stripped", **kw)
        got = mb(fx)
        rows = predict_run(weights=str(tmp / "update"), cfg=str(ORBAX_FIXTURE / "cfg.json"),
                           source=str(frame), imgsz=64, conf_thres=0.001, nosave=True,
                           update=True, device="cuda", project=str(tmp / "predict"))
        torch.cuda.synchronize()
        launches = {"dcnv3_sampling": dcnv3_sampling.launches,
                    "letterbox_normalize": letterbox_normalize.launches}
        per_fwd = sum(isinstance(m, DCNv3) for m in mb.model.modules())
        if launches["dcnv3_sampling"] < 2 * per_fwd or launches["letterbox_normalize"] < 1:
            failures.append(f"(a) launches {launches}: expected K2 {per_fwd} a forward for the "
                            "served checkpoint and the predicted frame, and K1 a frame")
        out["launches"] = launches
        gaps = [max_rel_gap(g, w) for g, w in zip(got, want)]
        out["served_max_rel_gap"] = gaps
        failures += [f"(a) served {n} {g} > {SAME_TOL}" for n, g in zip(("pred", "protos"), gaps)
                     if not g <= SAME_TOL]
        if ocdbt.load_checkpoint(tmp / "update", "epoch") != -1:
            failures.append("(a) segment.predict --update left the checkpoint unstripped")
        out["update_rows"] = len(rows[0])
        del ref, mb

        # (b) yolov5s-seg at full width to SavedModel, TFLite and int8 TFLite
        gen = torch.Generator().manual_seed(2)
        model = calibrate_bn(SegmentationModel("yolov5s-seg.json", device="cuda", generator=gen),
                             make_frames(3, seed=3))
        cpu_model = copy.deepcopy(model).cpu()
        files = {}
        for name, fn in (
                ("savedmodel", lambda: export.export_savedmodel(cpu_model, 640, tmp / "s_saved_model")),
                ("tflite", lambda: export.export_tflite(cpu_model, 640, tmp / "s.tflite")),
                ("tflite_int8", lambda: export.export_tflite(cpu_model, 640, tmp / "s_int8.tflite",
                                                             int8=True, device="cuda"))):
            t0 = time.perf_counter()
            files[name] = fn()
            out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"{name}_mb"] = dir_mb(files[name]) if files[name].is_dir() else \
                files[name].stat().st_size / 2 ** 20
        x = torch.rand(1, 640, 640, 3, generator=torch.Generator().manual_seed(4)).cuda()
        g = build_tf_graph(cpu_model, 640, fuse=True)
        with torch.inference_mode():
            lowered = run_tf_graph(g, x)
            lowered = (lowered["pred"], lowered["protos"].permute(0, 3, 1, 2))
            direct = model.fuse()(x.permute(0, 3, 1, 2))[:2]
            exact = model.double()(x.permute(0, 3, 1, 2).double())[:2]
        # a calibrated full-width float32 forward lies ~1.4e-4-2.5e-4 of the largest |pred|
        # from the float64 one (CPU, three memory layouts): the lowered graph is held to
        # twice the float32 forward's own gap to the float64 forward
        own = [max_rel_gap(d, e) for d, e in zip(direct, exact)]
        gaps = [max_rel_gap(lo, e) for lo, e in zip(lowered, exact)]
        out["lowered_graph_ops"] = len(g.nodes)
        out["float64_gap_lowered_and_forward"] = {"lowered": gaps, "forward": own}
        failures += [f"(b) lowered graph {n}: {v} from the float64 forward, over twice the "
                     f"float32 forward's {o}" for n, v, o in zip(("pred", "protos"), gaps, own)
                     if not v <= 2 * o + 1e-7]
        if not (files["savedmodel"] / "saved_model.pb").is_file():
            failures.append("(b) no saved_model.pb")
        for name in ("tflite", "tflite_int8"):
            if files[name].read_bytes()[4:8] != b"TFL3":
                failures.append(f"(b) {name}: no TFL3 identifier")
        out["files_checked_by"] = ("tests/test_torch_port_tf_export.py on the CPU "
                                   "(no tensorflow on this machine)")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["phase_6l_s"] = time.perf_counter() - t_phase
    print("weights out (6l) " + json.dumps(out), flush=True)
    print(f"phase 6l s {out['phase_6l_s']:.2f}", flush=True)
    if failures:
        raise AssertionError("weights out (6l): " + "; ".join(failures))
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


def train_setup(model, bs: int, accumulate: int, count: int = 0,
                hyp_name: str = "hyp.scratch-low.json", mesh=None, remat=False):
    """Trainer and state for `model`: SGD with `hyp_name` (weight decay scaled
    by bs · accumulate / 64), the EMA, the overlap segment loss; the
    optimizer's inner step count starts at `count`; with `mesh` (a rank of a
    data-parallel group) the trainer synchronises BatchNorm and wraps DDP;
    `remat` recomputes the forward in the backward."""
    from yolo_dual_tpu_torch.losses.segment import ComputeSegmentLoss
    from yolo_dual_tpu_torch.train.ema import ModelEMA
    from yolo_dual_tpu_torch.train.optim import smart_optimizer
    from yolo_dual_tpu_torch.train.trainer import Trainer
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg(hyp_name))
    head = model.model[-1]
    loss = ComputeSegmentLoss(head.anchors, head.strides, model.nc, head.nm, hyp, overlap=True)
    opt = smart_optimizer(model, "SGD", hyp, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                          accumulate=accumulate, total_batch_size=bs)
    opt.count = count
    trainer = Trainer(model, loss, opt, ModelEMA(model), task="segment", mesh=mesh, remat=remat)
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
    return launches, profile, out["epoch_img_per_s"]


# Phase 10b: the host augmentation route, --remat and rect validation on phase 10's set
HOST_HYP = "hyp.scratch-high.json"  # mixup 0.1, copy_paste 0.1: the host route
HOST_STEP_TOL = 1e-3  # first micro-step card vs CPU, TF32 off: items and gradients
HOST_STEP_BS = 4  # ... on the host batch's first 4 samples: its 16 took 50-66 s on the CPU
REMAT_TOL = 1e-4  # the remat micro-step against the plain one on the card
STATS_SHARE = 1e-5  # BatchNorm statistics, remat against plain, when not bitwise equal
RECT_MAP_TOL = 0.01  # segment.val --rect card vs CPU, each of the 8 metrics (as 6b)
RECT_CHECK_FRAMES = 8  # a bucket, card against CPU
RECT_CFG = "yolov5s-seg.json"  # as 6b: its self-labels hold from run to run


def host_batch_parts(root: Path, card: str):
    """One bs-16 batch of the host route (hyp.scratch-high, seed 0) built in
    this thread, timed by part: frame loads and resizes, the mosaic canvas,
    copy_paste, the warp's pixels and its labels, mixup's blend, augment_hsv,
    the polygon rasterising, and the rest (flips, label boxes, padding,
    stacking). Returns (batch, parts)."""
    from yolo_dual_tpu_torch.data import augment as augmod
    from yolo_dual_tpu_torch.data import dataset as dsmod
    from yolo_dual_tpu_torch.utils.general import find_cfg, load_config
    hyp = load_config(find_cfg(HOST_HYP))
    loader, ds = dsmod.create_dataloader(str(root / "images" / "train"), TRAIN_IMGSZ, TRAIN_BS,
                                         hyp=hyp, augment=True, shuffle=True,
                                         mask_downsample_ratio=4, overlap_mask=True, seed=0,
                                         device_aug=True)
    names = {(dsmod.YoloDataset, "load_image"): "load_image",
             (dsmod.YoloDataset, "load_mosaic"): "mosaic",
             (dsmod, "copy_paste"): "copy_paste", (dsmod, "random_perspective"): "warp",
             (augmod, "warp_affine_u8"): "warp_pixels", (dsmod, "mixup"): "mixup",
             (dsmod, "augment_hsv"): "hsv", (dsmod, "polygons2masks_overlap"): "rasterise"}
    spent = {v: 0.0 for v in names.values()}
    calls = {v: 0 for v in names.values()}
    saved = []
    for (owner, attr), key in names.items():
        fn = getattr(owner, attr)

        def wrapper(*a, _fn=fn, _key=key, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                spent[_key] += time.perf_counter() - t
                calls[_key] += 1
        setattr(owner, attr, wrapper)
        saved.append((owner, attr, fn))
    try:
        t0 = time.perf_counter()
        samples = [ds[i] for i in loader._indices()[:TRAIN_BS]]
        batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
        total = time.perf_counter() - t0
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    if ds.device_aug or "image" not in batch:
        raise AssertionError(f"host batch: {HOST_HYP} did not take the host route")
    ms = {k: v * 1e3 for k, v in spent.items()}
    parts = {"load_image": ms["load_image"],
             "canvas": ms["mosaic"] - ms["load_image"] - ms["copy_paste"] - ms["warp"],
             "copy_paste": ms["copy_paste"], "warp_pixels": ms["warp_pixels"],
             "warp_labels": ms["warp"] - ms["warp_pixels"], "mixup_blend": ms["mixup"],
             "hsv": ms["hsv"], "rasterise": ms["rasterise"]}
    parts["rest"] = total * 1e3 - ms["mosaic"] - ms["mixup"] - ms["hsv"] - ms["rasterise"]
    out = {"card": card, "bs": TRAIN_BS, "imgsz": TRAIN_IMGSZ, "hyp": HOST_HYP,
           "host_batch_ms": total * 1e3, "parts_ms": parts, "mosaics": calls["mosaic"],
           "mixups": calls["mixup"], "frames_loaded": calls["load_image"],
           "instances_in_batch": int(batch["tmask"].sum())}
    print("host batch " + json.dumps(out), flush=True)
    return batch, out


def grad_gaps(a: dict, b: dict) -> dict:
    """Gradients `a` against `b` (b on the CPU): the largest |a − b| of any
    tensor over the largest |b| of the model (the share held), and the 3
    tensors whose own share, max |a − b| over their max |b|, is largest
    among those whose max |b| exceeds 1e-6 of the model's (a bias that a
    BatchNorm follows has a gradient of 0 but for rounding)."""
    top = max(v.abs().max().item() for v in b.values())
    diff = {k: (a[k].double() - v.double()).abs().max().item() for k, v in b.items()}
    own = sorted(((diff[k] / v.abs().max().item(), k) for k, v in b.items()
                  if v.abs().max().item() > 1e-6 * top), reverse=True)
    return {"share_of_largest": max(diff.values()) / top, "largest": top,
            "worst_own_share_3": [[v, k] for v, k in own[:3]]}


def host_step_card_vs_cpu(batch: dict) -> dict:
    """The first micro-step's forward, loss and backward of yolov5s-seg-dcnv3
    (phase 7's weights) on the first HOST_STEP_BS samples of the host batch,
    on the card and on the CPU from the same weights, TF32 off: loss items
    within HOST_STEP_TOL of the largest, every gradient within HOST_STEP_TOL
    of the model's largest (grad_gaps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = {k: v[:HOST_STEP_BS] for k, v in batch.items()}
    model = dcnv3_train_model()
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).train()
        trainer, _ = train_setup(m, HOST_STEP_BS, 1, hyp_name=HOST_HYP)
        t = time.perf_counter()
        loss, items = trainer.forward_loss(m, batch)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"items": items.detach().cpu(), "s": time.perf_counter() - t,
                    "grads": {k: q.grad.detach().cpu() for k, q in m.named_parameters()}}
        del m, trainer
    torch.backends.cudnn.allow_tf32 = True
    g, c = out["cuda"], out["cpu"]
    return {"items_card": g["items"].tolist(), "items_cpu": c["items"].tolist(),
            "items_share": share(g["items"], c["items"]),
            "grads": grad_gaps(g["grads"], c["grads"]), "cpu_step_s": c["s"],
            "tolerance": HOST_STEP_TOL}


def remat_phase(batch: dict, card: str) -> dict:
    """--remat on one bs-16 host batch: a micro-step (accumulate 4, so no
    optimizer update; TF32 off) of two copies of yolov5s-seg-dcnv3, one plain
    and one rematerialised, launches counted: loss items and gradients within
    REMAT_TOL of the largest (grad_gaps), the BatchNorm statistics equal; then
    each timed with TF32 convolutions (CUDA events) with its peak memory."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import dcnv3_sampling, dcnv3_sampling_backward
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dcnv3_train_model()
    gpu_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
                 if k in ("image", "targets", "tmask", "masks")}
    runs = {}
    for remat in (False, True):
        m = copy.deepcopy(base)
        trainer, state = train_setup(m, TRAIN_BS, ACCUMULATE, hyp_name=HOST_HYP, remat=remat)
        # the checked step with TF32 off: with it on, the two runs' convolutions may take
        # algorithms of other TF32 roundings (their free memory differs), ~1e-3 apart
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize()
        dcnv3_sampling.launches = dcnv3_sampling_backward.launches = 0
        state, metrics = trainer.train_step(state, gpu_batch)
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32 = True  # timed as the CLI trains
        launches = {"dcnv3_sampling": dcnv3_sampling.launches,
                    "dcnv3_sampling_backward": dcnv3_sampling_backward.launches}
        first = {"items": metrics["items"].cpu(),
                 "grads": {k: q.grad.detach().cpu() for k, q in m.named_parameters()},
                 "buffers": {k: b.detach().cpu() for k, b in m.named_buffers()}}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: trainer.train_step(state, gpu_batch), 4, warmup=1)
        runs[remat] = {**first, "launches": launches, "micro_step_ms": step_ms,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del m, trainer, state
        torch.cuda.empty_cache()
    plain, rem = runs[False], runs[True]
    gaps = grad_gaps(rem["grads"], plain["grads"])
    # equal, or (where the card's reductions are not bitwise repeatable) the batch counts
    # equal and the statistics within STATS_SHARE: a second update would move them by about
    # the momentum (0.03) times their distance from the batch statistics
    stats_equal = all(torch.equal(rem["buffers"][k], v) for k, v in plain["buffers"].items())
    stats_share = max(share(rem["buffers"][k], v) for k, v in plain["buffers"].items()
                      if v.is_floating_point() and v.abs().max() > 0)
    counts_equal = all(torch.equal(rem["buffers"][k], v) for k, v in plain["buffers"].items()
                       if not v.is_floating_point())
    out = {"card": card, "bs": TRAIN_BS, "imgsz": TRAIN_IMGSZ, "accumulate": ACCUMULATE,
           "plain": {k: plain[k] for k in ("launches", "micro_step_ms", "peak_memory_gb")},
           "remat": {k: rem[k] for k in ("launches", "micro_step_ms", "peak_memory_gb")},
           "items_share": share(rem["items"], plain["items"]), "grads": gaps,
           "batchnorm_stats_equal": stats_equal, "batchnorm_counts_equal": counts_equal,
           "batchnorm_stats_share": stats_share, "tolerance": REMAT_TOL}
    print("remat " + json.dumps(out), flush=True)
    n_dcn = sum(DCN_PATH_SHAPES.values())
    problems = []
    if plain["launches"] != {"dcnv3_sampling": n_dcn, "dcnv3_sampling_backward": n_dcn}:
        problems.append(f"plain micro-step launches {plain['launches']}")
    if rem["launches"] != {"dcnv3_sampling": 2 * n_dcn, "dcnv3_sampling_backward": n_dcn}:
        problems.append(f"remat micro-step launches {rem['launches']}")
    if out["items_share"] > REMAT_TOL or gaps["share_of_largest"] > REMAT_TOL:
        problems.append(f"remat against plain: items {out['items_share']}, "
                        f"gradients {gaps['share_of_largest']}")
    if not (stats_equal or (counts_equal and stats_share <= STATS_SHARE)):
        problems.append(f"remat changed the BatchNorm statistics (share {stats_share}, "
                        f"counts equal {counts_equal})")
    if problems:
        raise AssertionError("remat: " + "; ".join(problems))
    return {k: plain["launches"][k] + rem["launches"][k] for k in plain["launches"]}


def write_rect_set(root: Path, src: Path, cfg: str) -> Path:
    """Phase 10's train frames (`src`) under root/images/train (and the same
    as val), labelled with the primed `cfg`'s own boxes (seeded weights,
    BatchNorm calibrated on the first rect batch, prime_for_eval): the model
    loaded and fused as segment.val loads it, run on the rect batches
    segment.val makes (YoloDataset(rect=True) through the Loader, bs 16),
    through the validator's multi-label NMS; its first EVAL_MAX_BOXES rows a
    frame that, clipped to the canvas, are wider and taller than 2 px and lie
    inside the frame's part of it, written as 4-vertex polygons normalised to
    the frame. Returns the primed weights' path."""
    from yolo_dual_tpu_torch.data.dataset import create_dataloader
    from yolo_dual_tpu_torch.data.loader import normalize_image
    from yolo_dual_tpu_torch.engine.validator import PRE_NMS_TOPK
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.ops.nms import nms_from_raw
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
    loader, ds = create_dataloader(str(src), TRAIN_IMGSZ, TRAIN_BS, rect=True,
                                   mask_downsample_ratio=4, overlap_mask=True)
    first = torch.from_numpy(next(iter(loader))["image"]).cuda().permute(0, 3, 1, 2)
    model = SegmentationModel(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    calibrate_bn_on(model, normalize_image(first).contiguous())
    torch.save(prime_for_eval(model).state_dict(), root / "primed.pt")
    model = SegmentationModel(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(load_state_dict_file(root / "primed.pt"), strict=True)
    model.eval().fuse()
    head = model.model[-1]
    with torch.inference_mode():
        for batch in loader:
            image = torch.from_numpy(batch["image"]).cuda().permute(0, 3, 1, 2)
            h, w = image.shape[2:]
            levels, _ = model(normalize_image(image).contiguous(), decode=False)
            # the validator's own NMS, so each label is one of its top rows
            out, nv = nms_from_raw([lv.float() for lv in levels], head.anchors, head.strides,
                                   conf_thres=0.001, iou_thres=0.6, multi_label=True,
                                   max_det=300, nm=head.nm, pre_nms_topk=PRE_NMS_TOPK)
            out, nv = out.cpu().numpy(), nv.tolist()
            for si in range(int(batch["n_valid"])):
                d = out[si, :nv[si]].copy()
                # clipped to the canvas as the validator matches them, and inside the
                # frame's part of it: a label cannot reach the pad
                d[:, [0, 2]] = d[:, [0, 2]].clip(0, w)
                d[:, [1, 3]] = d[:, [1, 3]].clip(0, h)
                dw, dh = (float(v) for v in batch["ratio_pad"][si])
                d = d[((d[:, 2] - d[:, 0]) > 2) & ((d[:, 3] - d[:, 1]) > 2) & (d[:, 0] >= dw)
                      & (d[:, 2] <= w - dw) & (d[:, 1] >= dh) & (d[:, 3] <= h - dh)]
                d = d[:EVAL_MAX_BOXES]
                lines = []
                for row in d:
                    x1, x2 = np.clip((row[[0, 2]] - dw) / (w - 2 * dw), 0, 1)
                    y1, y2 = np.clip((row[[1, 3]] - dh) / (h - 2 * dh), 0, 1)
                    lines.append(f"{int(row[5])} " + " ".join(
                        f"{v:.6f}" for v in (x1, y1, x2, y1, x2, y2, x1, y2)))
                f = Path(ds.im_files[int(batch["index"][si])])
                for split in ("train", "val"):
                    np.save(root / "images" / split / f.name, np.load(f))
                    (root / "labels" / split / f.with_suffix(".txt").name).write_text(
                        "\n".join(lines))
    return root / "primed.pt"


def rect_val_phase(root: Path, card: str) -> dict:
    """segment.val --rect --task train on phase 10's train frames (the
    720x1280 ones in the 0.7 bucket, the others in the square one), labelled
    with the primed yolov5s-seg's own boxes (write_rect_set; the random
    DCNv3 model is chaotic in float32: its labels found in one run matched
    23% of its rows in the next): the whole split on the
    card (speed line, batches a bucket, box mAP50 above 0.05),
    then RECT_CHECK_FRAMES frames of each bucket on the card and on the CPU,
    TF32 off, each metric within RECT_MAP_TOL."""
    import shutil
    from yolo_dual_tpu_torch.data.dataset import create_dataloader
    from yolo_dual_tpu_torch.segment import val
    frames = sorted((root / "images" / "train").glob("*.npy"))
    rect = root / "rect"
    shutil.rmtree(rect, ignore_errors=True)
    weights = write_rect_set(rect, root / "images" / "train", RECT_CFG)
    loader, ds = create_dataloader(str(rect / "images" / "train"), TRAIN_IMGSZ, TRAIN_BS,
                                   rect=True, mask_downsample_ratio=4, overlap_mask=True)
    batches = {}
    for chunk in loader._chunks():
        shape = "x".join(map(str, ds.bucket_shapes[ds.bucket_of[chunk[0]]]))
        batches[shape] = batches.get(shape, 0) + 1
    kw = dict(weights=str(weights), cfg=RECT_CFG, batch_size=TRAIN_BS, imgsz=TRAIN_IMGSZ,
              rect=True, task="train")
    t = time.perf_counter()
    mean, _, times = val.run(data=str(rect), device="cuda", **kw)
    run_s = time.perf_counter() - t
    by_bucket = {}
    for f, b in zip(ds.im_files, ds.bucket_of):
        by_bucket.setdefault(int(b), []).append(f)
    subset = sorted(f for fs in by_bucket.values() for f in fs[:RECT_CHECK_FRAMES])
    listing = rect / "check.txt"
    listing.write_text("\n".join(subset) + "\n")
    data = rect / "check.json"
    data.write_text(json.dumps({"path": str(rect), "train": listing.name, "val": listing.name,
                                "nc": 80}))
    torch.backends.cudnn.allow_tf32 = False
    check = {dev: val.run(data=str(data), device=dev, **dict(kw, batch_size=RECT_CHECK_FRAMES))[0]
             for dev in ("cuda", "cpu")}
    torch.backends.cudnn.allow_tf32 = True
    gap = float(np.abs(np.asarray(check["cuda"], np.float64)
                       - np.asarray(check["cpu"], np.float64)).max())
    out = {"card": card, "frames": len(frames), "batches_by_bucket_shape": batches,
           "metrics": [float(v) for v in mean], "speed_ms_pre_infer_post": list(times),
           "run_s": run_s, "img_per_s": len(frames) / run_s,
           "check_frames": len(subset), "check_card": [float(v) for v in check["cuda"]],
           "check_cpu": [float(v) for v in check["cpu"]], "check_max_gap": gap,
           "tolerance": RECT_MAP_TOL}
    print("rect val " + json.dumps(out), flush=True)
    if len(batches) != 2 or gap > RECT_MAP_TOL or not mean[2] > 0.05:
        raise AssertionError(f"rect val: buckets {batches}, mAP50 {mean[2]} / {mean[6]}, card "
                             f"vs CPU gap {gap}")
    return out


def host_route_path(card: str, device_epoch_img_s: float):
    """Phase 10b on phase 10's dataset: (a) segment.train on the host route
    (yolov5s-seg-dcnv3, hyp.scratch-high, 640 px, bs 16, f32, 1 epoch,
    --image-weights --cache disk; launches counted), one host batch timed by
    part and its first micro-step card vs CPU; (b) --remat against the plain
    micro-step; (c) segment.val --rect --task train on its frames, relabelled.
    Returns the launches of (a) and (b)."""
    from yolo_dual_tpu_torch.io.weights import load_state_dict_file
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    root = Path(__file__).resolve().parent / "build" / "phase10"
    project = root / "runs"
    n_train, n_val = (sum(CLI_SETS[k].values()) for k in ("train", "val"))
    steps, val_batches = -(-n_train // TRAIN_BS), -(-n_val // TRAIN_BS)
    n_dcn = sum(DCN_PATH_SHAPES.values())
    probe = CliProbe()
    try:
        (epochs, items), launches = cli_launches(lambda: probe.run(
            ["--cfg", "yolov5s-seg-dcnv3.json", "--data", str(root), "--hyp", HOST_HYP,
             "--imgsz", str(TRAIN_IMGSZ), "--batch-size", str(TRAIN_BS), "--project",
             str(project), "--noplots", "--device", "cuda", "--epochs", "1", "--dtype", "f32",
             "--image-weights", "--cache", "disk", "--name", "host"]))
    finally:
        probe.close()
    res = cli_results(project / "host")
    for f in ("last.pt", "best.pt"):
        SegmentationModel("yolov5s-seg-dcnv3.json", device="cpu").load_state_dict(
            load_state_dict_file(project / "host" / f), strict=True)
    want = {"letterbox_normalize": 0, "dcnv3_sampling": n_dcn * (steps + val_batches),
            "dcnv3_sampling_backward": n_dcn * steps}
    train_s = epochs[0]["train_s"]
    cli = {"card": card, "model": "yolov5s-seg-dcnv3", "hyp": HOST_HYP, "bs": TRAIN_BS,
           "imgsz": TRAIN_IMGSZ, "flags": ["--image-weights", "--cache disk"],
           "launches": launches, "results": res.tolist(), "first_micro_step_items": items,
           "epoch_train_s": train_s, "epoch_img_per_s": n_train / train_s,
           "device_route_epoch_img_per_s_phase10": device_epoch_img_s,
           "val_s": epochs[0]["val_s"], "save_s": epochs[0]["save_s"]}
    print("host route cli " + json.dumps(cli), flush=True)
    if res.shape[0] != 1 or not np.isfinite(res[:, 1:5]).all() or launches != want:
        raise AssertionError(f"host route cli: results {res.tolist()}, launches {launches}, "
                             f"expected {want}")
    batch, _ = host_batch_parts(root, card)
    check = host_step_card_vs_cpu(batch)
    print(f"host micro-step card vs cpu (bs {HOST_STEP_BS}, 640 px, tf32 off) " + json.dumps(check),
          flush=True)
    if check["items_share"] > HOST_STEP_TOL or check["grads"]["share_of_largest"] > HOST_STEP_TOL:
        raise AssertionError(f"host micro-step card vs CPU: {check}")
    remat_launches = remat_phase(batch, card)
    rect_val_phase(root, card)
    print(f"phase 10b s {time.perf_counter() - t0:.2f}", flush=True)
    return launches, remat_launches


# --- phase 6k: data parallelism over torch.distributed and the utils layer ----------------

DP_RANKS, DP_BS, DP_CYCLE = 2, TRAIN_BS, ACCUMULATE  # 2 ranks on cuda:0; global bs 16 (8 a rank)
DP_CYCLE_SEED = 600  # micro-step k of 6k (a) draws its global batch from rng(DP_CYCLE_SEED + k)
DP_UPDATE_TOL = 5e-3  # a parameter's update, 2 ranks against one process on the same rows: max
DP_UPDATE_FLOOR = 1e-3  # gap over (its max update + DP_UPDATE_FLOOR x the model's largest update)
DP_STAT_TOL = 1e-5  # BatchNorm statistics: max gap / max |statistic|
# both limits are held above the card's spread (one process against itself) and below the
# gaps of per-rank BatchNorm (the fault), each measured in the phase
DP_MAP_TOL = 2e-3  # segment.val's 8 metrics, 2 ranks against one process
DP_TIMEOUT_S = 420


def dp_cycle(mesh, start: Path, device="cuda", rows=None, sync_bn=True, bs=DP_BS, cycle=DP_CYCLE,
             seed=DP_CYCLE_SEED):
    """One accumulation cycle (`cycle` micro-steps, the optimizer's step on the
    last) of yolov5s-seg-dcnv3 at 640 px from the weights in `start`, on the
    global batches rng(seed + k) of `bs`: this rank's rows of each (and on a
    2-D mesh its band of their rows) under `mesh` (the port's synchronised
    BatchNorm and DDP), the whole batch
    without one, its rows in the order `rows` where given. `sync_bn` False
    leaves each rank's BatchNorm on its own rows (DDP without synchronised
    BatchNorm: the fault that 6k (a)'s limit must catch). Returns
    (state_dict, EMA state_dict, each micro-step's items and ms, the host
    clock around it and a synchronise)."""
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.parallel.mesh import convert_sync_batchnorm, shard_batch
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device=device)
    model.load_state_dict(torch.load(start, map_location=device, weights_only=True))
    trainer, state = train_setup(model, bs, cycle, count=1000, mesh=mesh)
    if not sync_bn:
        convert_sync_batchnorm(model, None)
    items, ms = [], []
    for k in range(cycle):
        b = train_batch(np.random.default_rng(seed + k), bs, TRAIN_IMGSZ, "cpu")
        if rows is not None:
            b = {key: v[rows] for key, v in b.items()}
        b = {key: v.to(device) for key, v in (shard_batch(b, mesh) if mesh else b).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, b)
        items.append([float(v) for v in m["items"].tolist()])
        ms.append((time.perf_counter() - t) * 1e3)
    if state.optimizer.count != 1001 or state.ema.updates != 1:
        raise AssertionError(f"6k cycle: {state.optimizer.count} steps, {state.ema.updates} EMA")
    return ({k: v.detach().cpu() for k, v in model.state_dict().items()},
            {k: v.detach().cpu() for k, v in state.ema.ema.state_dict().items()}, items, ms)


def dp_rank(out: Path) -> int:
    """A rank of phase 6k, started by torch.distributed.run: (a) the DDP cycle,
    then its fault reference with per-rank BatchNorm, (b) segment.train --data-parallel --sync-bn, (c) segment.val
    --data-parallel --device-preprocess, each with the kernels' counts set to 0
    just before and read just after; writes out/rank{r}.json."""
    from yolo_dual_tpu_torch.parallel.mesh import data_parallel
    from yolo_dual_tpu_torch.segment import train as segment_train
    from yolo_dual_tpu_torch.segment import val as segment_val
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    job = json.loads((out / "job.json").read_text())
    mesh = data_parallel("cuda")
    if mesh is None or mesh.size != DP_RANKS:
        raise AssertionError(f"6k rank: no {DP_RANKS}-rank group ({mesh})")
    res = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device)}
    t = time.perf_counter()
    (sd, ema, items, ms), res["cycle_launches"] = cli_launches(
        lambda: dp_cycle(mesh, out / "start.pt"))
    res["cycle_s"], res["cycle_items"], res["micro_step_ms"] = time.perf_counter() - t, items, ms
    torch.save({"state": sd, "ema": ema}, out / f"cycle_rank{mesh.rank}.pt")
    (sd, ema, _, _), res["fault_launches"] = cli_launches(
        lambda: dp_cycle(mesh, out / "start.pt", sync_bn=False))
    torch.save({"state": sd, "ema": ema}, out / f"cycle_rank{mesh.rank}_local_bn.pt")
    t = time.perf_counter()
    _, res["train_launches"] = cli_launches(lambda: segment_train.main(job["train_args"]))
    res["train_s"] = time.perf_counter() - t
    t = time.perf_counter()
    (mean, _, times), res["val_launches"] = cli_launches(
        lambda: segment_val.run(**job["val_kw"]))
    res.update(val_s=time.perf_counter() - t, val_mean=[float(v) for v in mean],
               val_times_ms=list(times))
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def run_process_group(cmd, timeout: float, log: Path, env=None) -> int:
    """Run cmd in a session of its own, its output to `log`; on the timeout the
    whole session is killed, so no rank outlives the phase."""
    import signal
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                             env=env)
        try:
            return p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            raise


def max_gap(a: dict, b: dict, keys, floor: float = 0.0) -> tuple:
    """The largest gap between two state dicts over `keys`, each relative to its
    tensor's largest |b| plus `floor` (a bias whose update is rounding, ahead
    of a BatchNorm, moves by next to nothing): (gap, key)."""
    return max(((float((a[k].double() - b[k].double()).abs().max())
                 / max(float(b[k].double().abs().max()) + floor, 1e-12), k) for k in keys),
               default=(0.0, ""))


def dp_cut_set(src: Path, dst: Path, n: int = 16) -> Path:
    """The first n 480x640 frames of each of phase 10's splits, with their labels."""
    import shutil
    for split in ("train", "val"):
        for sub in ("images", "labels"):
            (dst / sub / split).mkdir(parents=True)
        for f in sorted((src / "images" / split).glob("480x640_*.npy"))[:n]:
            shutil.copy(f, dst / "images" / split / f.name)
            shutil.copy(src / "labels" / split / f"{f.stem}.txt", dst / "labels" / split)
    return dst


def data_parallel_path(card: str) -> dict:
    """Phase 6k: 2 ranks sharing cuda:0 over gloo (parallel/mesh.py's rule for
    ranks that share a card), TF32 off. (a) One accumulation cycle of
    yolov5s-seg-dcnv3 at 640 px, global bs 16 (8 a rank), synchronised
    BatchNorm, against one process's bs-16 cycle from the same weights on
    the global batch's rows in the ranks' order (rows 0, 2, ..., 1, 3, ...;
    the row order alone moves the card's updates by more than the ranks do):
    the ranks hold identical parameters, and the parameters' updates and the
    BatchNorm statistics agree with one process's within DP_UPDATE_TOL and
    DP_STAT_TOL. Those limits are held above the card's spread (that cycle
    run again) and below the gaps of the same 2 ranks with per-rank
    BatchNorm (DDP without synchronised statistics); the cycle on the rows
    in their own order is reported. (b) segment.train --data-parallel --sync-bn --epochs 1 through
    torch.distributed.run on 16 + 16 frames of phase 10's set: rank 0 writes
    results.csv and last.pt, which then loads in this process. (c) segment.val
    --data-parallel --device-preprocess (K1 on each rank's batch) of the primed
    model on a self-labelled set of 32 frames: the 8 metrics within DP_MAP_TOL
    of one process's. (d) autobatch at 640 px (the bytes at each candidate and
    the card's mem_get_info total), model_info and profile of the fused bs-16
    forward (GFLOPs, ms, TFLOP/s), check_bf16 (held on the seeded initial
    weights; on the calibrated model with steep DCNv3 heads only recorded:
    a random network amplifies bf16's rounding), a torch.profiler trace under
    build/phase6k, and segment.train --evolve 1 --epochs 1 (1 row of
    evolve.csv, one mutated generation: cut from 2 to pay for 6m's time; the
    plot is skipped with a logged line without matplotlib).
    Returns the kernels' launches on the phase's paths, the ranks' included."""
    import shutil
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.segment import train as segment_train
    from yolo_dual_tpu_torch.segment import val as segment_val
    from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint
    from yolo_dual_tpu_torch.utils import autobatch, profiling
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent / "build" / "phase6k"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    data = dp_cut_set(Path(__file__).resolve().parent / "build" / "phase10", root / "data")
    launches = {"letterbox_normalize": 0, "dcnv3_sampling": 0, "dcnv3_sampling_backward": 0}

    def count(part):
        for k, v in part.items():
            launches[k] += v

    # the start weights (a) and the primed model's val set (c)
    model = dcnv3_train_model()
    torch.save(model.state_dict(), root / "start.pt")
    prime_for_eval(model)
    (val_root, _), part = cli_launches(lambda: (write_val_set(
        root / "val", model, make_frames(32, seed=6, sizes=(EVAL_SHAPE,))), None))
    count(part)
    torch.save(model.state_dict(), root / "primed.pt")
    del model
    val_kw = dict(data=str(val_root), weights=str(root / "primed.pt"), cfg="yolov5s-seg-dcnv3.json",
                  batch_size=DP_BS, imgsz=640, conf_thres=0.001, iou_thres=0.6, device="cuda",
                  device_preprocess=True)
    base_args = ["--cfg", "yolov5s-seg-dcnv3.json", "--data", str(data), "--hyp",
                 "hyp.scratch-low.json", "--imgsz", str(TRAIN_IMGSZ), "--batch-size", str(DP_BS),
                 "--nbs", str(DP_BS), "--epochs", "1", "--dtype", "f32", "--device", "cuda",
                 "--project", str(root / "runs")]
    train_args = base_args + ["--name", "dp", "--data-parallel", "--sync-bn"]
    (root / "job.json").write_text(json.dumps({"train_args": train_args,
                                               "val_kw": {**val_kw, "data_parallel": True}}))
    # (a) one process's cycles: the global batch's rows in the ranks' order (0, 2, ..., 1,
    # 3, ...) twice, the reference and the card's spread, and once in their own order (the
    # row order alone moves the updates by more than the ranks do: summation orders)
    rank_rows = torch.from_numpy(np.concatenate([np.arange(r, DP_BS, DP_RANKS)
                                                 for r in range(DP_RANKS)]))
    t = time.perf_counter()
    (one_sd, one_ema, one_items, one_ms), part = cli_launches(
        lambda: dp_cycle(None, root / "start.pt", rows=rank_rows))
    count(part)
    one_cycle_s = time.perf_counter() - t
    (again_sd, _, _, _), part = cli_launches(
        lambda: dp_cycle(None, root / "start.pt", rows=rank_rows))
    count(part)
    (own_sd, _, own_items, _), part = cli_launches(lambda: dp_cycle(None, root / "start.pt"))
    count(part)
    # (c) one process's val
    (one_mean, _, _), part = cli_launches(lambda: segment_val.run(**val_kw))
    count(part)
    # the ranks
    t = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(DP_RANKS), str(Path(__file__).resolve()), "--dp-rank", str(root)]
    rc = run_process_group(cmd, DP_TIMEOUT_S, root / "ranks.log")
    ranks_s = time.perf_counter() - t
    if rc != 0:
        print((root / "ranks.log").read_text()[-6000:], flush=True)
        raise AssertionError(f"6k: torch.distributed.run exited {rc}")
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    for r in ranks:
        for key in ("cycle_launches", "fault_launches", "train_launches", "val_launches"):
            count(r[key])
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"6k: backends {[r['backend'] for r in ranks]}, gloo expected")
    # (a) the ranks against each other and against one process
    cyc = [torch.load(root / f"cycle_rank{r}.pt", weights_only=True) for r in range(DP_RANKS)]
    start = torch.load(root / "start.pt", map_location="cpu", weights_only=True)
    if not all(torch.equal(cyc[0][s][k], cyc[1][s][k]) for s in ("state", "ema") for k in start):
        raise AssertionError("6k (a): the ranks' parameters, statistics or EMA differ")
    params = [k for k in start if "running" not in k and "num_batches" not in k]
    stats = [k for k in start if "running" in k]
    dp_upd = {k: cyc[0]["state"][k] - start[k] for k in params}
    one_upd = {k: one_sd[k] - start[k] for k in params}
    floor = DP_UPDATE_FLOOR * max(float(u.abs().max()) for u in one_upd.values())
    upd_gap, upd_key = max_gap(dp_upd, one_upd, params, floor)
    stat_gap, stat_key = max_gap(cyc[0]["state"], one_sd, stats)
    one_ema_upd = {k: one_ema[k] - start[k] for k in params}
    ema_gap, ema_key = max_gap({k: cyc[0]["ema"][k] - start[k] for k in params}, one_ema_upd,
                               params, DP_UPDATE_FLOOR * max(float(u.abs().max())
                                                             for u in one_ema_upd.values()))
    upd_gap_bare, upd_key_bare = max_gap(dp_upd, one_upd, params)
    items_gap = float(np.abs(np.array(ranks[0]["cycle_items"]) - np.array(one_items)).max())
    local = torch.load(root / "cycle_rank0_local_bn.pt", weights_only=True)["state"]
    spread = {}
    for name, sd in (("again", again_sd), ("local_bn", local), ("own_row_order", own_sd)):
        gap, key = max_gap({k: sd[k] - start[k] for k in params}, one_upd, params, floor)
        bare, bare_key = max_gap({k: sd[k] - start[k] for k in params}, one_upd, params)
        sgap, skey = max_gap(sd, one_sd, stats)
        spread[name] = {"update_gap": gap, "key": key, "update_gap_without_floor": bare,
                        "its_key": bare_key, "stat_gap": sgap, "stat_key": skey}
    spread["own_row_order"]["items_gap"] = float(
        np.abs(np.array(own_items) - np.array(one_items)).max())
    if upd_gap > DP_UPDATE_TOL or ema_gap > DP_UPDATE_TOL or stat_gap > DP_STAT_TOL:
        raise AssertionError(f"6k (a): update gap {upd_gap} ({upd_key}), EMA {ema_gap}, "
                             f"statistics {stat_gap} ({stat_key}); spread {spread}")
    again, fault = spread["again"], spread["local_bn"]
    if not (again["update_gap"] <= DP_UPDATE_TOL < fault["update_gap"]
            and again["stat_gap"] <= DP_STAT_TOL < fault["stat_gap"]):
        raise AssertionError(f"6k (a): the limits {DP_UPDATE_TOL}, {DP_STAT_TOL} do not lie "
                             f"between the card's spread and the fault's gaps: {spread}")
    # (b) rank 0's run directory; last.pt loads in one process
    run = root / "runs" / "dp"
    res = cli_results(run)
    if res.shape != (1, 10) or not np.isfinite(res).all():
        raise AssertionError(f"6k (b): results.csv {res}")
    ckpt = load_checkpoint(run / "last.pt")
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda")
    model.load_state_dict(ckpt["model"], strict=True)
    (levels, _), part = cli_launches(lambda: model.eval()(torch.zeros(1, 3, 640, 640,
                                                                      device="cuda"),
                                                          decode=False))
    count(part)
    if ckpt["epoch"] != 0 or len(ckpt.get("data_rng_ranks", [])) != DP_RANKS:
        raise AssertionError(f"6k (b): last.pt epoch {ckpt['epoch']}")
    # (c) the ranks' metrics against one process's
    map_gap = max(float(np.abs(np.array(r["val_mean"]) - np.array(one_mean)).max()) for r in ranks)
    if map_gap > DP_MAP_TOL or not (one_mean[2] > 0.05 and one_mean[6] > 0.05):
        raise AssertionError(f"6k (c): metrics {ranks[0]['val_mean']} against {list(one_mean)}")
    val_batches = -(-32 // DP_BS)
    if any(r["val_launches"]["letterbox_normalize"] != val_batches for r in ranks):
        raise AssertionError(f"6k (c): K1 launches {[r['val_launches'] for r in ranks]}")
    out = {"card": card, "ranks": DP_RANKS, "backend": ranks[0]["backend"],
           "global_bs": DP_BS, "ranks_s": ranks_s,
           "a": {"one_process_cycle_s": one_cycle_s, "rank_cycle_s": [r["cycle_s"] for r in ranks],
                 "one_process_micro_step_ms": one_ms,
                 "rank_micro_step_ms": [r["micro_step_ms"] for r in ranks],
                 "update_gap": upd_gap, "update_gap_key": upd_key, "ema_gap": ema_gap,
                 "update_gap_without_floor": upd_gap_bare, "its_key": upd_key_bare,
                 "largest_update": floor / DP_UPDATE_FLOOR,
                 "stat_gap": stat_gap, "stat_gap_key": stat_key, "items_gap": items_gap,
                 "tol": {"update": DP_UPDATE_TOL, "floor": DP_UPDATE_FLOOR, "stat": DP_STAT_TOL},
                 "spread": spread,
                 "launches_a_rank": ranks[0]["cycle_launches"]},
           "b": {"train_s": [r["train_s"] for r in ranks], "results": res[0].tolist(),
                 "launches_a_rank": ranks[0]["train_launches"]},
           "c": {"val_s": [r["val_s"] for r in ranks], "map_gap": map_gap, "tol": DP_MAP_TOL,
                 "metrics": ranks[0]["val_mean"], "one_process": [float(v) for v in one_mean],
                 "launches_a_rank": ranks[0]["val_launches"]}}
    # (d) the utilities, in this process
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda")
    model.load_state_dict(start)
    record = {}
    t = time.perf_counter()
    pick, part = cli_launches(lambda: autobatch.autobatch(model, imgsz=640, record=record))
    count(part)
    total = torch.cuda.mem_get_info()[1]
    (n_layers, n_params, gflops), part = cli_launches(lambda: profiling.model_info(model, 640))
    count(part)
    model.fuse()
    x = torch.rand(DP_BS, 3, 640, 640, device="cuda")
    fwd = lambda t: model(t, decode=False)  # noqa: E731
    (t_min, t_med, fl), part = cli_launches(lambda: profiling.profile(fwd, x, n=10, warmup=2,
                                                                      model=model))
    count(part)
    # bf16 against float32 on the seeded initial weights; the calibrated random model with
    # its steep DCNv3 heads amplifies bf16's rounding past JAX's atol (recorded, not held)
    model2 = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda",
                               generator=torch.Generator().manual_seed(0))
    bf16_ok, part = cli_launches(lambda: profiling.check_bf16(model2, imgsz=256))
    count(part)
    model2.load_state_dict(start)
    bf16_calibrated, part = cli_launches(lambda: profiling.check_bf16(model2, imgsz=256))
    count(part)
    _, part = cli_launches(lambda: profiling.trace(fwd, x, log_dir=str(root / "trace")))
    count(part)
    trace_bytes = (root / "trace" / "trace.json").stat().st_size
    evolve_csv, part = cli_launches(lambda: segment_train.main(
        base_args + ["--name", "evo", "--evolve", "1", "--noplots"]))
    count(part)
    evolve_rows = len(Path(evolve_csv).read_text().strip().splitlines()) - 1
    try:
        import matplotlib  # noqa: F401
        plotted = (Path(evolve_csv).parent / "evolve.png").exists()
    except ImportError:
        plotted = None  # skipped, with the logged line
    if evolve_rows != 1 or plotted is False or not bf16_ok or trace_bytes == 0:
        raise AssertionError(f"6k (d): evolve rows {evolve_rows}, plot {plotted}, bf16 {bf16_ok}, "
                             f"trace {trace_bytes} bytes")
    out["d"] = {"autobatch_pick": pick, "autobatch_bytes": record, "mem_get_info_total": total,
                "model_info": {"layers": n_layers, "parameters": n_params,
                               "gflops_640_bs1": gflops},
                "profile_bs16_fused": {"min_ms": t_min * 1e3, "median_ms": t_med * 1e3,
                                       "gflop": fl / 1e9, "tflops": fl / t_min / 1e12},
                "check_bf16": bf16_ok, "check_bf16_calibrated": bf16_calibrated,
                "trace_bytes": trace_bytes, "evolve_rows": evolve_rows,
                "evolve_plot": plotted, "utils_s": time.perf_counter() - t}
    out["launches"] = launches
    out["phase_6k_s"] = time.perf_counter() - t_phase
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print("data parallel and utils (6k) " + json.dumps(out), flush=True)
    print(f"phase 6k s {out['phase_6k_s']:.2f}", flush=True)
    return launches


# --- phase 6m: spatial partitioning over a data x space mesh ------------------------------

SP_DP, SP_SP, SP_BS, SP_CYCLE = 2, 2, 4, 2  # 4 ranks on cuda:0; global bs 4, 2 micro-steps
SP_CYCLE_SEED = 700  # micro-step k of 6m draws its global batch from rng(SP_CYCLE_SEED + k)
SP_UPDATE_TOL = DP_UPDATE_TOL  # a parameter's update, the ranks against one process (6k's rule)
SP_STAT_TOL = DP_STAT_TOL  # BatchNorm statistics: max gap / max |statistic|
# both limits are held above the card's spread (one process against itself) and below the
# gaps of the same ranks without halo exchanges (the fault), each measured in the phase. The
# cycles run on cuDNN's deterministic algorithms: with its default ones the spread reached
# 3.69e-3 (--sp-spread: cuDNN's atomics, then K3's). So run, three runs read the ranks' update
# gap 3.69e-3 each, the spread 2.35e-4 to 4.18e-4 (K3's atomics) and the fault 1.72;
# statistics 2.4e-7, spread 0, fault 4.9e-3
SP_EVAL_FRAMES = 8
SP_TIMEOUT_S = 300


def halo_less_rows(x, top, bottom, fill=0.0, dim=2, mesh=None):
    """parallel/spatial.py:halo_rows as a band without neighbours computes it:
    every band padded with the layer's edge fill (6m's fault reference)."""
    if dim != 2:
        raise ValueError("halo_less_rows pads NCHW maps")
    x = F.pad(x, (0, 0, max(top, 0), max(bottom, 0)), value=fill)
    return x if bottom >= 0 else x[:, :, :x.shape[2] + bottom]


def sp_eval(root: Path, mesh):
    """evaluate_segment of the primed model (root/primed.pt) on root/val's
    SP_EVAL_FRAMES frames at global bs SP_BS, K1 letterboxing each batch of a
    rank's frames; on a 2-D mesh each rank takes its data shard's frames
    (shard_loader) and runs the forward on its band."""
    from yolo_dual_tpu_torch.data.dataset import create_dataloader
    from yolo_dual_tpu_torch.engine.validator import evaluate_segment
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    from yolo_dual_tpu_torch.parallel.mesh import shard_loader
    from yolo_dual_tpu_torch.utils.general import check_dataset
    model = SegmentationModel("yolov5s-seg-dcnv3.json", device="cuda")
    model.load_state_dict(torch.load(root / "primed.pt", map_location="cuda", weights_only=True))
    d = check_dataset(str(root / "val"))
    loader, _ = create_dataloader(d["val"], 640, SP_BS, device_preprocess=True, augment=False,
                                  mask_downsample_ratio=4, overlap_mask=True, task="segment")
    shard_loader(loader, mesh)
    return evaluate_segment(model, loader, model.nc, conf_thres=0.001, iou_thres=0.6,
                            nm=model.model[-1].nm, mesh=mesh, device="cuda")


def sp_rank(out: Path) -> int:
    """A rank of phase 6m, started by torch.distributed.run: the 2 x 2 mesh,
    then (a) the accumulation cycle on its band of its data shard's rows,
    (b) the same cycle without halo exchanges (the fault reference), (c)
    evaluate_segment of SP_EVAL_FRAMES frames, each with the kernels' counts
    set to 0 just before and read just after; writes out/rank{r}.json."""
    from yolo_dual_tpu_torch.parallel import spatial
    from yolo_dual_tpu_torch.parallel.mesh import init_distributed, make_mesh_2d
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False  # as 6m's
    init_distributed("cuda")
    mesh = make_mesh_2d(SP_DP, SP_SP)
    rank = mesh.rank * mesh.sp + mesh.space_rank
    res = {"rank": rank, "data": mesh.rank, "space": mesh.space_rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    cycle = lambda: dp_cycle(mesh, out / "start.pt", bs=SP_BS, cycle=SP_CYCLE,  # noqa: E731
                             seed=SP_CYCLE_SEED)
    torch.cuda.reset_peak_memory_stats()
    spatial.counts.clear()
    t = time.perf_counter()
    (sd, ema, items, ms), res["cycle_launches"] = cli_launches(cycle)
    res.update(cycle_s=time.perf_counter() - t, cycle_items=items, micro_step_ms=ms,
               peak_bytes=torch.cuda.max_memory_allocated(), exchanges=dict(spatial.counts))
    torch.save({"state": sd, "ema": ema}, out / f"cycle_rank{rank}.pt")
    real, spatial.halo_rows = spatial.halo_rows, halo_less_rows
    try:
        (sd, _, _, _), res["fault_launches"] = cli_launches(cycle)
    finally:
        spatial.halo_rows = real
    torch.save({"state": sd}, out / f"cycle_rank{rank}_no_halo.pt")
    t = time.perf_counter()
    (mean, _, times), res["eval_launches"] = cli_launches(lambda: sp_eval(out, mesh))
    res.update(eval_s=time.perf_counter() - t, eval_mean=[float(v) for v in mean],
               eval_times_ms=list(times))
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def band_kernel_phase() -> dict:
    """K2 and K3 with row0 != 0: at each DCN_PATH_SHAPES map (a data shard of
    2 images) split into SP_SP bands, every band's output, doffset and dmask
    and its dx over the whole map against the plain versions on the same
    inputs, within phases 2 and 4's tolerances; the bands' outputs against
    the whole map's plain rows too. These launches count on no path."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (dcnv3_core, dcnv3_core_bwd,
                                                          dcnv3_sampling, dcnv3_sampling_backward)
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = (3, 1, 1, 1, 1)
    out = {}
    for (h, w, c) in DCN_PATH_SHAPES:
        x, offset, mask = dcnv3_inputs(gen, SP_BS // SP_DP, h, w, c)
        g = torch.randn(SP_BS // SP_DP, h, w, c, device="cuda", generator=gen)
        whole = dcnv3_core(x, offset, mask, *args, c, 1.0)
        fwd = bwd = 0.0
        for s in range(SP_SP):
            r0, n = s * h // SP_SP, h // SP_SP
            band = [t[:, r0:r0 + n].contiguous() for t in (offset, mask, g)]
            with torch.no_grad():
                got = dcnv3_sampling(x, band[0], band[1], *args, c, 1.0, r0)
                ref = dcnv3_core(x, band[0], band[1], *args, c, 1.0, r0)
            fwd = max(fwd, (got - ref).abs().max().item(),
                      (got - whole[:, r0:r0 + n]).abs().max().item())
            kb = dcnv3_sampling_backward(x, *band, *args, c, 1.0, r0)
            pb = dcnv3_core_bwd(x, *band, *args, c, 1.0, r0)
            bwd = max([bwd] + [(a - r).abs().max().item() / max(1.0, r.abs().max().item())
                               for a, r in zip(kb, pb)])
        torch.cuda.synchronize()
        if not (fwd <= 1e-5 and bwd <= 1e-5):
            raise AssertionError(f"6m: K2 / K3 on bands of {h}x{w}x{c}: errors {fwd}, {bwd}")
        out[f"{SP_BS // SP_DP}x{h}x{w}x{c}"] = {"K2_max_abs_err": fwd, "K3_max_rel_err": bwd}
    return out


def sp_spread(runs: int) -> dict:
    """Where 6m's spread comes from: 6m's one-process reference cycle, `runs`
    times in each of four settings from one start (TF32 off), and in each
    the largest update and statistics gaps of a run from the setting's first
    (6m's rule): "default"; "cudnn_deterministic" (cuDNN's deterministic
    algorithms, its benchmark off); "deterministic" (torch's deterministic
    algorithms as well, deterministic_algorithms); "deterministic_plain_k3"
    (K3 swapped for its plain version, whose scatter-add is deterministic
    there). Each setting takes away one source of run-to-run variation:
    cuDNN's atomics, torch's, K3's."""
    import shutil
    from yolo_dual_tpu_torch.kernels import dcn_sampling
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent / "build" / "sp_spread"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.save(dcnv3_train_model().state_dict(), root / "start.pt")
    start = torch.load(root / "start.pt", map_location="cpu", weights_only=True)
    params = [k for k in start if "running" not in k and "num_batches" not in k]
    stats = [k for k in start if "running" in k]
    rank_rows = torch.from_numpy(np.concatenate([np.arange(d, SP_BS, SP_DP)
                                                 for d in range(SP_DP)]))

    def cycle():
        return dp_cycle(None, root / "start.pt", rows=rank_rows, bs=SP_BS, cycle=SP_CYCLE,
                        seed=SP_CYCLE_SEED)[0]

    def plain_k3(x, offset, mask, grad_out, *cfg):
        return dcn_sampling.dcnv3_core_bwd(x, offset, mask, grad_out, *cfg)

    out = {}
    for name in ("default", "cudnn_deterministic", "deterministic", "deterministic_plain_k3"):
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        k3 = dcn_sampling.dcnv3_sampling_backward
        try:
            with deterministic_algorithms(name.startswith("deterministic")):
                if name == "cudnn_deterministic":
                    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
                if name.endswith("plain_k3"):
                    dcn_sampling.dcnv3_sampling_backward = plain_k3
                sds = [cycle() for _ in range(runs)]
        finally:
            dcn_sampling.dcnv3_sampling_backward = k3
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        first = {k: sds[0][k] - start[k] for k in params}
        floor = DP_UPDATE_FLOOR * max(float(u.abs().max()) for u in first.values())
        gaps = []
        for sd in sds[1:]:
            upd, key = max_gap({k: sd[k] - start[k] for k in params}, first, params, floor)
            stat, skey = max_gap(sd, sds[0], stats)
            gaps.append({"update_gap": upd, "key": key, "stat_gap": stat, "stat_key": skey,
                         "bit_equal": all(torch.equal(sd[k], sds[0][k]) for k in start)})
        out[name] = gaps
        print(f"sp spread {name} " + json.dumps(gaps), flush=True)
    return out


def spatial_path(card: str) -> dict:
    """Phase 6m: a dp 2 x sp 2 mesh of 4 ranks sharing cuda:0 over gloo
    (parallel/mesh.py's rule), TF32 off. Each rank runs (a) one accumulation
    cycle (SP_CYCLE micro-steps) of yolov5s-seg-dcnv3 at full width and 640
    px, global bs 4: 2 rows a data shard, 320 rows a band, from the weights
    6k starts from, (b) the same cycle with every band padded by its edge
    fill instead of its neighbours' rows (the fault reference) and (c)
    evaluate_segment of the primed model on SP_EVAL_FRAMES self-labelled
    frames; this process runs (a) twice on the global batch (its rows in the
    ranks' order: the reference, then the card's spread) and (c) once, all on
    cuDNN's deterministic algorithms (SP_UPDATE_TOL). The
    ranks hold identical parameters; their updates and BatchNorm statistics
    agree with the reference within SP_UPDATE_TOL and SP_STAT_TOL, which lie
    above the spread and below the fault's gaps; the metrics within
    DP_MAP_TOL; K2 and K3 with row0 != 0 agree with their plain versions
    (band_kernel_phase). Returns the kernels' launches on the phase's paths."""
    import shutil
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    # cuDNN's deterministic algorithms, here and on the ranks: SP_UPDATE_TOL
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    root = Path(__file__).resolve().parent / "build" / "phase6m"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = {"letterbox_normalize": 0, "dcnv3_sampling": 0, "dcnv3_sampling_backward": 0}

    def count(part):
        for k, v in part.items():
            launches[k] += v

    model = dcnv3_train_model()
    torch.save(model.state_dict(), root / "start.pt")
    prime_for_eval(model)
    _, part = cli_launches(lambda: write_val_set(
        root / "val", model, make_frames(SP_EVAL_FRAMES, seed=8, sizes=(EVAL_SHAPE,))))
    count(part)
    torch.save(model.state_dict(), root / "primed.pt")
    del model
    bands = band_kernel_phase()
    # one process on the global batch, its rows in the ranks' order (0, 2, 1, 3): the
    # reference and the card's spread, each alone on the card
    rank_rows = torch.from_numpy(np.concatenate([np.arange(d, SP_BS, SP_DP)
                                                 for d in range(SP_DP)]))
    cycle = lambda: dp_cycle(None, root / "start.pt", rows=rank_rows, bs=SP_BS,  # noqa: E731
                             cycle=SP_CYCLE, seed=SP_CYCLE_SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (one_sd, one_ema, one_items, one_ms), part = cli_launches(cycle)
    one_peak = torch.cuda.max_memory_allocated()
    count(part)
    (again_sd, _, _, _), part = cli_launches(cycle)
    count(part)
    (one_mean, _, _), part = cli_launches(lambda: sp_eval(root, None))
    count(part)
    torch.cuda.empty_cache()
    # the ranks
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(SP_DP * SP_SP), str(Path(__file__).resolve()), "--sp-rank", str(root)]
    t = time.perf_counter()
    rc = run_process_group(cmd, SP_TIMEOUT_S, root / "ranks.log")
    ranks_s = time.perf_counter() - t
    if rc != 0:
        print((root / "ranks.log").read_text()[-6000:], flush=True)
        raise AssertionError(f"6m: torch.distributed.run exited {rc}")
    world = SP_DP * SP_SP
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(world)]
    for r in ranks:
        for key in ("cycle_launches", "eval_launches"):
            count(r[key])
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"6m: backends {[r['backend'] for r in ranks]}, gloo expected")
    n_dcn = sum(DCN_PATH_SHAPES.values())
    for r in ranks:
        want = {"dcnv3_sampling": n_dcn * SP_CYCLE, "dcnv3_sampling_backward": n_dcn * SP_CYCLE}
        if any(r["cycle_launches"][k] != v for k, v in want.items()) or \
                r["eval_launches"]["dcnv3_sampling"] == 0 or \
                r["eval_launches"]["letterbox_normalize"] == 0:
            raise AssertionError(f"6m: rank {r['rank']} launches {r['cycle_launches']}, "
                                 f"{r['eval_launches']}")
        ex = r["exchanges"]
        if set(ex) != {"halo Conv", "halo max_pool", "gather dcnv3", "gather head"} or \
                ex["gather dcnv3"] != n_dcn * SP_CYCLE:
            raise AssertionError(f"6m: rank {r['rank']} exchanges {ex}")
    cyc = [torch.load(root / f"cycle_rank{r}.pt", weights_only=True) for r in range(world)]
    start = torch.load(root / "start.pt", map_location="cpu", weights_only=True)
    if not all(torch.equal(c[s][k], cyc[0][s][k]) for c in cyc[1:] for s in ("state", "ema")
               for k in start):
        raise AssertionError("6m (a): the ranks' parameters, statistics or EMA differ")
    params = [k for k in start if "running" not in k and "num_batches" not in k]
    stats = [k for k in start if "running" in k]
    one_upd = {k: one_sd[k] - start[k] for k in params}
    floor = DP_UPDATE_FLOOR * max(float(u.abs().max()) for u in one_upd.values())

    def gaps(sd):
        upd, key = max_gap({k: sd[k] - start[k] for k in params}, one_upd, params, floor)
        stat, skey = max_gap(sd, one_sd, stats)
        return {"update_gap": upd, "key": key, "stat_gap": stat, "stat_key": skey}
    got = gaps(cyc[0]["state"])
    one_ema_upd = {k: one_ema[k] - start[k] for k in params}
    ema_gap, ema_key = max_gap({k: cyc[0]["ema"][k] - start[k] for k in params}, one_ema_upd,
                               params, DP_UPDATE_FLOOR * max(float(u.abs().max())
                                                             for u in one_ema_upd.values()))
    spread = gaps(again_sd)
    fault = gaps(torch.load(root / "cycle_rank0_no_halo.pt", weights_only=True)["state"])
    items_gap = float(np.abs(np.array(ranks[0]["cycle_items"]) - np.array(one_items)).max())
    if got["update_gap"] > SP_UPDATE_TOL or ema_gap > SP_UPDATE_TOL or \
            got["stat_gap"] > SP_STAT_TOL:
        raise AssertionError(f"6m (a): gaps {got}, EMA {ema_gap} ({ema_key}); spread {spread}, "
                             f"fault {fault}")
    if not (spread["update_gap"] <= SP_UPDATE_TOL < fault["update_gap"]
            and spread["stat_gap"] <= SP_STAT_TOL < fault["stat_gap"]):
        raise AssertionError(f"6m (a): the limits {SP_UPDATE_TOL}, {SP_STAT_TOL} do not lie "
                             f"between the card's spread {spread} and the fault's gaps {fault}")
    map_gap = max(float(np.abs(np.array(r["eval_mean"]) - np.array(one_mean)).max())
                  for r in ranks)
    if map_gap > DP_MAP_TOL or not (one_mean[2] > 0.05 and one_mean[6] > 0.05):
        raise AssertionError(f"6m (c): metrics {ranks[0]['eval_mean']} against {list(one_mean)}")
    out = {"card": card, "mesh": [SP_DP, SP_SP], "backend": ranks[0]["backend"],
           "global_bs": SP_BS, "imgsz": TRAIN_IMGSZ, "band_rows": TRAIN_IMGSZ // SP_SP,
           "ranks_s": ranks_s,
           "micro_step_ms": {"ranks": [r["micro_step_ms"] for r in ranks],
                             "one_process": one_ms},
           "peak_bytes": {"ranks": [r["peak_bytes"] for r in ranks], "one_process": one_peak},
           "update_gap": got["update_gap"], "update_gap_key": got["key"], "ema_gap": ema_gap,
           "stat_gap": got["stat_gap"], "stat_gap_key": got["stat_key"], "items_gap": items_gap,
           "tol": {"update": SP_UPDATE_TOL, "floor": DP_UPDATE_FLOOR, "stat": SP_STAT_TOL,
                   "map": DP_MAP_TOL},
           "spread": spread, "fault_no_halo": fault,
           "eval": {"map_gap": map_gap, "metrics": ranks[0]["eval_mean"],
                    "one_process": [float(v) for v in one_mean],
                    "eval_s": [r["eval_s"] for r in ranks]},
           "exchanges_a_rank_cycle": ranks[0]["exchanges"],
           "launches_a_rank": {"cycle": ranks[0]["cycle_launches"],
                               "eval": ranks[0]["eval_launches"]},
           "bands_row0": bands, "launches": launches}
    out["phase_6m_s"] = time.perf_counter() - t_phase
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    print("spatial partitioning (6m) " + json.dumps(out), flush=True)
    print(f"phase 6m s {out['phase_6m_s']:.2f}", flush=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device-times", metavar="ROOT", nargs="?",
                    const=str(Path(__file__).resolve().parent),
                    help="only K1's phase 3 and K1's, K2's and K3's device times, of the "
                         "package under ROOT")
    ap.add_argument("--proof-spread", metavar="RUNS", type=int,
                    help="only the four learning proofs, each RUNS times with deterministic "
                         "algorithms and RUNS times without")
    ap.add_argument("--sp-spread", metavar="RUNS", type=int,
                    help="only 6m's one-process cycle, RUNS times in each of four settings of "
                         "deterministic algorithms (sp_spread)")
    ap.add_argument("--dp-rank", metavar="DIR",
                    help="run as a rank of phase 6k under torch.distributed.run (DIR: its job)")
    ap.add_argument("--sp-rank", metavar="DIR",
                    help="run as a rank of phase 6m under torch.distributed.run (DIR: its job)")
    ap.add_argument("--learning-proof", nargs=5, metavar=("CFG", "NAME", "ROOT", "IMAGES", "JSON"),
                    help="run one learning proof of 6d / 6e in this process (learning_proofs)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.dp_rank:
        return dp_rank(Path(args.dp_rank))
    if args.sp_rank:
        return sp_rank(Path(args.sp_rank))
    if args.learning_proof:
        cfg, name, root, images, masks = args.learning_proof
        return learning_proof_process(cfg, name, Path(root), (Path(images), Path(masks)))
    root = Path(args.device_times or Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root))
    from yolo_dual_tpu_torch.kernels.build import library_path, load_library

    t_start = time.perf_counter()
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

    if args.sp_spread:
        for name in ("letterbox", "dcnv3", "dcnv3_bwd"):
            load_library(name)
        print(f"sp spread ({card}) " + json.dumps(sp_spread(args.sp_spread)), flush=True)
        return 0

    def elapsed(phase):
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

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
    elapsed("3")

    # 4-6. each model's prediction path; 7. the training path; 8. training, card vs CPU
    frames = make_frames(N_FRAMES)
    by_path = {cfg.removesuffix(".json"): model_path(cfg, frames, card) for cfg in MODELS}
    elapsed("4-6")
    # 6b. the validation slice: segment.val at bs 32 through K1
    by_path["eval yolov5s-seg"], eval_batch = eval_path(card)
    elapsed("6b")
    # 6c. the semantic flagship: semantic.val on both routes (K1 on the device route),
    # semantic.predict
    by_path["eval semantic resnet50"], semantic_profile = semantic_path(card)
    elapsed("6c")
    # 6d. the semantic flagship trains: one step card vs CPU, semantic.train on both routes,
    # --resume, the learning proof
    semantic_train_k1, semantic_train_profile = semantic_train_path(card)
    by_path["train semantic resnet50"] = {"letterbox_normalize": sum(semantic_train_k1.values())}
    elapsed("6d")
    # 6e. the YOLO semantic family: semantic.val, .predict, .train, the learning proofs
    yolo_k1, yolo_paths = yolo_semantic_path(card)
    by_path["eval semantic yolo"] = {"letterbox_normalize": yolo_paths["eval"]}
    by_path["train semantic yolo"] = {"letterbox_normalize": yolo_paths["train"]}
    elapsed("6e")
    # 6f. the detect zoo through build_model and AutoShape (no kernel on its path)
    by_path["detect zoo"] = detect_zoo_path(card)
    elapsed("6f")
    # 6g. classification: 13 classifiers, then classify.train, .val and .predict (no kernel on
    # its path)
    by_path["classify"] = classify_path(card)
    elapsed("6g")
    # 6h. the AuxOTA dual head trains and serves (no kernel on its path); the 6d graph; segment.val
    # with TTA and soft-NMS (K1 a batch) and segment.predict --augment (K1 a frame)
    t6h = time.perf_counter()
    by_path["auxota"], auxota_profile = auxota_path(card)
    zoo_6d_path(card)
    tta_k1 = tta_path(card)
    by_path["tta soft-nms val"] = {"letterbox_normalize": tta_k1["val"]}
    by_path["tta predict"] = {"letterbox_normalize": tta_k1["predict"]}
    print(f"phase 6h s {time.perf_counter() - t6h:.2f}", flush=True)
    elapsed("6h")
    # 6i. the HTTP model server and its client on yolov5s-seg-dcnv3 (K2 6 a request) and
    # resnet50, segment.predict's outputs (K1 a frame) and segment.val --save-json (K1 a batch)
    by_path["serve yolov5s-seg-dcnv3"], serve_k1, serve_profile = serve_path(card)
    by_path["predict outputs"] = {"letterbox_normalize": serve_k1["predict"]}
    by_path["val --save-json"] = {"letterbox_normalize": serve_k1["val"]}
    elapsed("6i")
    # 6j. weights in and out: export, MultiBackend and Ensemble at full width (K2 6 a forward),
    # the JAX package's orbax fixture served without JAX (K2), ONNX through cv2.dnn
    by_path["weights in and out"] = weights_path(card)
    elapsed("6j")
    # 6l. weights out: the orbax fixture stripped by the port's writer and served (K2), predict
    # --update (K1, K2); yolov5s-seg to SavedModel, TFLite and int8 TFLite (no kernel)
    by_path["weights out"] = weights_out_path(card)
    elapsed("6l")
    by_path["train yolov5s-seg-dcnv3"], trained, train_profile, step_ms = train_path(card)
    elapsed("7")
    train_card_vs_cpu()
    elapsed("8")
    # 10. the train CLI on a dataset on disk
    by_path["train CLI yolov5s-seg-dcnv3"], cli_profile, device_epoch_img_s = \
        cli_train_path(card, step_ms)
    elapsed("10")
    # 10b. the host augmentation route, --remat and rect validation on phase 10's set
    by_path["train CLI host route"], by_path["remat micro-steps"] = \
        host_route_path(card, device_epoch_img_s)
    elapsed("10b")
    # 6k. data parallelism on 2 ranks sharing the card (K2, K3 and K1 on the ranks' paths)
    # and the utils layer, on a cut of phase 10's set
    by_path["data parallel and utils"] = data_parallel_path(card)
    elapsed("6k")
    # 6m. spatial partitioning: a data x space mesh of 4 ranks on the card (K2 and K3 on the
    # bands, K1 in the evaluation)
    by_path["spatial partitioning"] = spatial_path(card)
    elapsed("6m")

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
    print("auxota train profile " + json.dumps(auxota_profile()), flush=True)
    del auxota_profile
    print("serve burst profile " + json.dumps(serve_profile()), flush=True)
    del serve_profile
    elapsed("9 and the profiles")

    # 11. kernels line: times are means over the launches of the main paths, each
    # launch weighted by the shape it ran at
    def total(kernel):
        return sum(p.get(kernel, 0) for p in by_path.values())

    def wmean(res, weights, key):
        return float(sum(res[n][key] * k for n, k in weights.items()) / sum(weights.values()))
    lcalls = {n: len(MODELS) * [list(MAIN_SHAPES)[i % len(MAIN_SHAPES)]
                                for i in range(N_FRAMES)].count(n) for n in MAIN_SHAPES}
    lcalls["val_480p_bs32_no_scaleup"] = by_path["eval yolov5s-seg"]["letterbox_normalize"] \
        + tta_k1["val"] + serve_k1["val"]
    lcalls["480p"] += tta_k1["predict"] + serve_k1["predict"]
    lcalls["semantic_720x960_bs16_fill128"] = \
        by_path["eval semantic resnet50"]["letterbox_normalize"] \
        + semantic_train_k1["semantic_720x960_bs16_fill128"] \
        + yolo_k1["semantic_720x960_bs16_fill128"]
    lcalls["semantic_train_96_bs4_fill128"] = semantic_train_k1["semantic_train_96_bs4_fill128"] \
        + yolo_k1["semantic_train_96_bs4_fill128"]
    # K2: 16 frames at batch 1 (prediction) and the server's requests and warm-up (6i),
    # 8 micro-steps at bs 16 (training), and the CLIs' forwards at bs 16 (their micro-steps
    # and val batches, both routes) and 10b's remat micro-steps (two forwards each); K3: the
    # micro-steps. 6j's and 6l's launches (bs-8 forwards and the 64-px fixture), 6k's (the ranks'
    # bs-8 forwards and micro-steps, the utilities') and 6m's (the bands' and the references')
    # count in `launches`; the means weight the shapes phase 3 times
    n_dcn = sum(DCN_PATH_SHAPES.values())
    serve_fwd = by_path["serve yolov5s-seg-dcnv3"]["dcnv3_sampling"] // n_dcn
    bs16 = ("train CLI yolov5s-seg-dcnv3", "train CLI host route", "remat micro-steps")
    cli_fwd = sum(by_path[k]["dcnv3_sampling"] for k in bs16) // n_dcn
    cli_bwd = sum(by_path[k]["dcnv3_sampling_backward"] for k in bs16) // n_dcn
    dcalls = {f"{b}x{h}x{w}x{c}": n * reps for (h, w, c), n in DCN_PATH_SHAPES.items()
              for b, reps in ((1, N_FRAMES + serve_fwd), (TRAIN_BS, TRAIN_MICRO_STEPS + cli_fwd))}
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
