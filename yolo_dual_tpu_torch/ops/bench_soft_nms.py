"""Time ops/nms.py:soft_nms_padded against two other loops of the same
selections on one NVIDIA GPU. Run from the repository's root, as it takes its
timing helper from chip_smoke.py:

    python -m yolo_dual_tpu_torch.ops.bench_soft_nms [--out FILE]

The loops: soft_nms_padded (masked steps, as many as the most scores an image
has above the threshold, at most max_det, one host synchronization for that
count), JAX's loop as written (the host asks before each step whether an
image is still going, a synchronization a step) and max_det masked steps with
no check. Each case's seeded candidates are ranked scores over 40 px boxes
scattered on a 640 px image (iou_thres 0.6, max_det 300): either every image
has at least max_det scores above the threshold, or a few (20 at batch 1,
5-40 an image at batch 32). The three loops must keep the same rows with the
same scores; then each is timed by CUDA events.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

IOU_THRES, MAX_DET, N = 0.6, 300, 4096
CASES = {"bs32_conf0.001_all_live": (32, 0.001, None), "bs1_conf0.25_all_live": (1, 0.25, None),
         "bs1_conf0.25_few": (1, 0.25, (20, 20)), "bs32_conf0.25_few": (32, 0.25, (5, 40))}


def loop(boxes, scores, score_threshold: float, check_each_step: bool):
    """JAX's loop (check_each_step) or max_det masked steps, each selection as
    soft_nms_padded makes it."""
    from yolo_dual_tpu_torch.ops.nms import SOFT_NMS_SIGMA, _iou_one_vs_many
    bs = scores.shape[0]
    rows = torch.arange(bs, device=scores.device)
    cur = scores.clone()
    keep = torch.full((bs, MAX_DET), -1, dtype=torch.long, device=scores.device)
    kept = torch.zeros(bs, MAX_DET, dtype=scores.dtype, device=scores.device)
    for k in range(MAX_DET):
        best, i = cur.max(1)
        going = best > score_threshold
        if check_each_step and not bool(going.any()):
            break
        keep[:, k] = torch.where(going, i, -1)
        kept[:, k] = torch.where(going, best, 0.0)
        iou = _iou_one_vs_many(boxes[rows, i], boxes)
        cur = cur * torch.where(iou > IOU_THRES, torch.exp(-(iou ** 2) / SOFT_NMS_SIGMA), 1.0)
        cur[rows, i] = -1.0
    return keep, kept


def candidates(bs: int, threshold: float, few, gen: torch.Generator):
    """Boxes (bs, N, 4) and descending scores (bs, N): uniform in (0, 1), or
    with `few` = (lo, hi) scores an image above the threshold and the rest
    below it."""
    xy = torch.rand(bs, N, 2, generator=gen) * 600
    scores = torch.rand(bs, N, generator=gen)
    if few is not None:
        n_above = torch.randint(few[0], few[1] + 1, (bs, 1), generator=gen)
        above = torch.arange(N)[None] < n_above
        scores = torch.where(above, threshold + (1 - threshold) * scores, threshold * scores)
    scores = scores.sort(dim=1, descending=True, stable=True).values
    return torch.cat([xy, xy + 40], -1).cuda(), scores.cuda()


def run() -> dict:
    from chip_smoke import cuda_ms
    from yolo_dual_tpu_torch.ops.nms import soft_nms_padded
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "iou_thres": IOU_THRES, "max_det": MAX_DET, "candidates": N}
    for case, (bs, thr, few) in CASES.items():
        b, sc = candidates(bs, thr, few, gen)
        loops = {"soft_nms_padded": lambda: soft_nms_padded(b, sc, IOU_THRES, MAX_DET,
                                                            score_threshold=thr),
                 "check_each_step": lambda: loop(b, sc, thr, True),
                 "fixed_max_det": lambda: loop(b, sc, thr, False)}
        outs = {k: f() for k, f in loops.items()}
        ref = outs["soft_nms_padded"]
        if not all(torch.equal(ref[0], o[0]) and torch.equal(ref[1], o[1]) for o in outs.values()):
            raise AssertionError(f"soft-NMS loops keep different rows ({case})")
        row = {"bs": bs, "threshold": thr, "above_threshold_max": int((sc > thr).sum(1).max()),
               "rows_kept": int((ref[0] >= 0).sum()),
               "ms": {k: cuda_ms(f, 3) for k, f in loops.items()}}
        result[case] = row
        print(f"soft-nms {case} " + json.dumps(row), flush=True)
    print("soft-nms " + json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    result = run()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
