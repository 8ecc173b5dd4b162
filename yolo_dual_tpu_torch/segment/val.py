"""Instance-segmentation validation CLI, box + mask mAP50-95 (port of
segment/val.py).

Usage:
    python -m yolo_dual_tpu_torch.segment.val --data DIR --device-preprocess
    python -m yolo_dual_tpu_torch.segment.val --data data.json --weights best.pt --device-preprocess
    python -m yolo_dual_tpu_torch.segment.val --data DIR --rect --task train --verbose

`--data` is a directory holding `images/` (RGB uint8 `.npy` frames; with
`images/train` and `images/val`, those splits) and `labels/` (the
reference's txt labels), whose classes are the model config's; or a JSON
file with the data yaml's keys `path`, `train`, `val`, `test`, `nc` and
`names` (utils/general.py:check_dataset). `--task` picks the split (any of
the data's split keys, else val), or `speed` (val at conf 0.25, iou 0.45) or
`study` (val at 256..1536 px, a row of 8 metrics and 3 times a size in
study_{data}_{weights}.txt). Without --weights the model has random weights
drawn from a generator seeded with 0. With --device-preprocess the raw
frames (all of one shape) are letterboxed on the card by the letterbox
kernel; without it, on the host (data/dataset.py), as the train CLI's
per-epoch validation does, and with --rect each frame to its aspect
bucket's shape, batch by batch. --save-json writes each kept detection,
its mask as COCO RLE, to predictions.json in the run directory (COCO's
91-id categories when the val path names coco; COCOeval where pycocotools
is installed and `path`/annotations/instances_val2017.json exists). --half runs the forward in bfloat16
(torch.autocast), as JAX's flag maps to its bf16 policy. --cache ram keeps
the frames in memory (disk: the `.npy` frames are the cache); --dnn,
--workers and --no-download are accepted, as in JAX. --plots draws the PR,
F1, P and R curves of boxes and masks into the run directory (matplotlib);
--task study draws study.png where matplotlib is installed, else logs the
skip. --data-parallel under `python -m torch.distributed.run
--nproc-per-node N -m yolo_dual_tpu_torch.segment.val ...` evaluates each
rank's rows of every batch (the batch size rounded up to a multiple of N,
as JAX's) and gathers the statistics: the metrics equal one process's.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.dataset import create_dataloader
from yolo_dual_tpu_torch.engine.validator import evaluate_segment
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.parallel.mesh import data_parallel as join_data_parallel
from yolo_dual_tpu_torch.parallel.mesh import from_rank0, rank0_first, shard_loader
from yolo_dual_tpu_torch.utils.coco import coco80_to_coco91_class
from yolo_dual_tpu_torch.utils.general import (LOGGER, check_dataset, check_img_size,
                                               increment_path, select_device)

STUDY_SIZES = tuple(range(256, 1536 + 128, 128))  # --task study's image sizes (JAX's)


def run(data="data", weights="", cfg="yolov5s-seg.json", batch_size=16, imgsz=640,
        conf_thres=0.001, iou_thres=0.6, max_det=300, task="val", single_cls=False,
        verbose=False, mask_ratio=4, save_txt=False, save_conf=False, save_hybrid=False,
        project="runs/val-seg", name="exp", exist_ok=False, fuse=True, device="cuda",
        device_preprocess=False, augment=False, save_json=False, plots=False, soft_nms=False,
        data_parallel=False, rect=False, cache=False, half=False, dnn=False, workers=0,
        no_download=False):
    """Evaluate `weights` (or the seeded random model) on the `task` split of
    `data`. Returns evaluate_segment's (8 metrics, per-class maps, (pre,
    inference+NMS, post) ms)."""
    mesh = join_data_parallel(device) if data_parallel else None
    if mesh is not None and batch_size % mesh.size:
        batch_size = -(-batch_size // mesh.size) * mesh.size
        LOGGER.info(f"--data-parallel: batch size rounded up to {batch_size} ({mesh.size} ranks)")
    dev = select_device(device)
    d = check_dataset(data)
    imgsz = check_img_size(imgsz, 32)
    nc = 1 if single_cls else d["nc"]
    model = SegmentationModel(cfg, nc=nc, device=dev, generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(resolve_state_dict(weights), strict=True)
    save_dir = from_rank0(lambda: str(increment_path(Path(project) / name, exist_ok=exist_ok,
                                                     mkdir=True)), mesh) \
        if save_txt or save_json or plots else "."
    # COCO's 91-id category map and annotation file for COCOeval (JAX segment/val.py:86-101)
    class_map = anno_json = None
    if save_json and "coco" in str(d.get("val", "")):
        class_map = coco80_to_coco91_class()
        cand = Path(str(d.get("path", ""))) / "annotations" / "instances_val2017.json"
        anno_json = cand if cand.exists() else None
    with rank0_first(mesh):  # the label cache is written once
        loader, _ = create_dataloader(d[task if d.get(task) else "val"], imgsz, batch_size,
                                      device_preprocess=device_preprocess, augment=False,
                                      mask_downsample_ratio=mask_ratio, overlap_mask=True,
                                      task="segment", single_cls=single_cls, rect=rect,
                                      cache_images=cache)
    shard_loader(loader, mesh)
    mean, maps, t = evaluate_segment(
        model, loader, model.nc, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
        nm=model.model[-1].nm, names=d.get("names"), plots=plots, save_dir=save_dir,
        use_soft_nms=soft_nms, augment=augment, save_json=save_json, anno_json=anno_json,
        class_map=class_map, fuse=fuse,
        save_txt=save_txt, save_conf=save_conf, save_hybrid=save_hybrid,
        mesh=mesh, device=dev,
        amp_dtype=torch.bfloat16 if half else None, verbose=verbose)
    if save_txt:
        LOGGER.info(f"labels saved to {Path(save_dir) / 'labels'}")
    return mean, maps, t


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="data",
                   help="dataset directory (images/*.npy, labels/*.txt) or .json data file")
    p.add_argument("--weights", type=str, default="", help="a .pt state_dict or an orbax checkpoint directory of the JAX package")
    p.add_argument("--cfg", type=str, default="yolov5s-seg.json")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--task", default="val",
                   help="a split of the data (val, test, train), or speed or study")
    p.add_argument("--mask-ratio", type=int, default=4)
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--verbose", action="store_true", help="a row of metrics per class")
    p.add_argument("--save-txt", action="store_true", help="save results to labels/*.txt")
    p.add_argument("--save-conf", action="store_true", help="include confidence in txt rows")
    p.add_argument("--save-hybrid", action="store_true",
                   help="also write gt rows at conf 1.0 (autolabelling artifact)")
    p.add_argument("--project", default="runs/val-seg")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--no-fuse", dest="fuse", action="store_false",
                   help="disable conv+BN inference folding")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--device-preprocess", action="store_true",
                   help="letterbox + normalize raw frames on the card (uniform-shape datasets); "
                        "default: the host letterbox")
    p.add_argument("--rect", action="store_true",
                   help="aspect-bucket batches on the host letterbox (a fixed set of shapes)")
    p.add_argument("--cache", type=str, default=False, nargs="?", const="ram",
                   help="image cache: ram, or disk (the .npy frames are the decoded cache)")
    p.add_argument("--half", action="store_true", help="the forward in bfloat16 (autocast)")
    p.add_argument("--augment", action="store_true", help="TTA: multi-scale + flip inference")
    p.add_argument("--soft-nms", action="store_true", help="Gaussian soft-NMS variant")
    p.add_argument("--dnn", action="store_true", help="accepted for parity (OpenCV-DNN N/A)")
    p.add_argument("--workers", type=int, default=0,
                   help="accepted for parity (one prefetch thread reads the samples)")
    p.add_argument("--no-download", action="store_true", help="accepted: nothing is downloaded")
    p.add_argument("--save-json", action="store_true",
                   help="save COCO-RLE predictions.json (+COCOeval if pycocotools is installed)")
    p.add_argument("--plots", action="store_true", help="PR/F1/P/R curves (matplotlib)")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank a process under torch.distributed.run, batches split over them")
    return p.parse_args(argv)


def main(opt):
    """--task speed and study as JAX's segment/val.py:main runs them, any
    other task as one run on that split."""
    if opt.task == "speed":
        return run(**{**vars(opt), "task": "val", "conf_thres": 0.25, "iou_thres": 0.45})
    if opt.task == "study":
        f = f"study_{Path(opt.data).stem}_{Path(str(opt.weights)).stem}.txt"
        rows = []
        for sz in STUDY_SIZES:
            LOGGER.info(f"--- study imgsz {sz}")
            mean, _, t = run(**{**vars(opt), "task": "val", "imgsz": sz})
            rows.append(tuple(mean) + tuple(t))
        np.savetxt(f, rows, fmt="%10.4g")
        LOGGER.info(f"study saved to {f}")
        try:
            from yolo_dual_tpu_torch.utils.plots import plot_val_study
            plot_val_study(dir=".", x=STUDY_SIZES)
        except Exception as e:
            LOGGER.info(f"study plot skipped: {e}")
        return rows
    return run(**vars(opt))


if __name__ == "__main__":
    main(parse_opt())
