"""Instance-segmentation streaming prediction CLI (port of segment/predict.py).

Usage:
    python -m yolo_dual_tpu_torch.segment.predict --source data/images
    python -m yolo_dual_tpu_torch.segment.predict --weights best.pt --source img.jpg --device cpu

Without --weights the model has random weights drawn from a generator seeded
with 0. Reading image files and saving annotated images need OpenCV.
"""

from __future__ import annotations

import argparse

import torch

from yolo_dual_tpu_torch.engine.predictor import predict_images
from yolo_dual_tpu_torch.io.weights import load_state_dict_file
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.utils.general import check_img_size, select_device


def run(weights="", cfg="yolov5s-seg.json", source="data/images", imgsz=640,
        conf_thres=0.25, iou_thres=0.45, max_det=300, classes=None, agnostic_nms=False,
        project="runs/predict-seg", name="exp", save_txt=False, save_conf=False,
        nosave=False, line_thickness=3, hide_labels=False, hide_conf=False, nc=80,
        fuse=True, exist_ok=False, device="cuda", soft_nms=False, augment=False):
    dev = select_device(device)
    imgsz = check_img_size(imgsz, 32)
    model = SegmentationModel(cfg, nc=nc, device=dev, generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(load_state_dict_file(weights), strict=True)
    return predict_images(
        model, source, imgsz=imgsz, conf_thres=conf_thres, iou_thres=iou_thres,
        max_det=max_det, nm=model.model[-1].nm, classes=classes, agnostic_nms=agnostic_nms,
        save_dir=f"{project}/{name}", save_txt=save_txt, save_img=not nosave,
        line_thickness=line_thickness, hide_labels=hide_labels, hide_conf=hide_conf,
        fuse=fuse, save_conf=save_conf, exist_ok=exist_ok, device=dev, use_soft_nms=soft_nms,
        augment=augment)


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="", help="reference-style .pt state_dict")
    p.add_argument("--cfg", type=str, default="yolov5s-seg.json")
    p.add_argument("--source", type=str, default="data/images", help="image file or directory")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--classes", nargs="+", type=int)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--project", default="runs/predict-seg")
    p.add_argument("--name", default="exp")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true", help="include confidence in txt rows")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--line-thickness", type=int, default=3)
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--no-fuse", dest="fuse", action="store_false",
                   help="disable conv+BN inference folding")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--soft-nms", action="store_true", help="Gaussian soft-NMS")
    p.add_argument("--augment", action="store_true", help="TTA: multi-scale + flip inference")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
