"""Instance-segmentation streaming prediction CLI (port of segment/predict.py).

Usage:
    python -m yolo_dual_tpu_torch.segment.predict --source data/images
    python -m yolo_dual_tpu_torch.segment.predict --weights best.pt --source video.mp4 --device cpu
    python -m yolo_dual_tpu_torch.segment.predict --source frames/ --data data.json --save-crop

--source is an image, a video, an RGB uint8 `.npy` frame or a directory of
them, a webcam index, a stream URL, a `.streams` list file or "screen"
(engine/predictor.py:iter_source). Without --weights the model has random
weights drawn from a generator seeded with 0. --weights takes a `.pt` state_dict
or an orbax checkpoint directory of the JAX package (its EMA first). --update
first strips the optimizer state from a training checkpoint given as --weights
(a `.pt` with an `optimizer` entry; a plain state_dict is left as it is) or
rewrites an orbax directory as JAX's strip_optimizer does. --data takes the
class names and count from a data file or directory, whose splits need not
exist. --retina-masks, --half and --dnn are accepted and change nothing, as
in JAX (masks are always upsampled to the frame). Reading image files and
videos, streams, and saving or showing annotated frames need OpenCV; the
screen needs mss; crops and feature maps are `.npy` without cv2 and
matplotlib.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from yolo_dual_tpu_torch.engine.predictor import predict_images
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint, strip_optimizer
from yolo_dual_tpu_torch.utils.general import check_dataset, check_img_size, select_device


def run(weights="", cfg="yolov5s-seg.json", source="data/images", imgsz=640,
        conf_thres=0.25, iou_thres=0.45, max_det=300, classes=None, agnostic_nms=False,
        retina_masks=False, project="runs/predict-seg", name="exp", save_txt=False,
        save_conf=False, nosave=False, line_thickness=3, hide_labels=False, hide_conf=False,
        nc=80, data=None, fuse=True, exist_ok=False, device="cuda", soft_nms=False,
        augment=False, vid_stride=1, max_frames=None, view_img=False, save_crop=False,
        visualize=False, update=False, half=False, dnn=False):
    dev = select_device(device)
    if update and weights and (not str(weights).endswith(".pt")
                               or load_checkpoint(weights).get("optimizer") is not None):
        strip_optimizer(weights)
    imgsz = check_img_size(imgsz, 32)
    names = None
    if data:
        # names and nc only: prediction does not need the splits on disk
        d = check_dataset(data, require_splits=False)
        nc = int(d["nc"]) if d.get("nc") is not None else nc
        names = d.get("names")
    model = SegmentationModel(cfg, nc=nc, device=dev, generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(resolve_state_dict(weights), strict=True)
    return predict_images(
        model, source, imgsz=imgsz, conf_thres=conf_thres, iou_thres=iou_thres,
        max_det=max_det, nm=model.model[-1].nm, classes=classes, agnostic_nms=agnostic_nms,
        retina_masks=retina_masks, save_dir=str(Path(project) / name), save_txt=save_txt,
        save_img=not nosave, names=names, line_thickness=line_thickness,
        hide_labels=hide_labels, hide_conf=hide_conf, use_soft_nms=soft_nms, augment=augment,
        vid_stride=vid_stride, max_frames=max_frames, view_img=view_img, fuse=fuse,
        save_crop=save_crop, save_conf=save_conf, exist_ok=exist_ok, visualize=visualize,
        device=dev)


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="", help="a .pt state_dict or an orbax checkpoint directory of the JAX package")
    p.add_argument("--cfg", type=str, default="yolov5s-seg.json")
    p.add_argument("--source", type=str, default="data/images",
                   help="image/video/.npy file or directory, webcam index, URL, .streams, screen")
    p.add_argument("--data", type=str, default=None,
                   help="dataset file or directory for class names")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--classes", nargs="+", type=int)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--retina-masks", action="store_true",
                   help="accepted: masks are always upsampled to the frame")
    p.add_argument("--project", default="runs/predict-seg")
    p.add_argument("--name", default="exp")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true", help="include confidence in txt rows")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--visualize", action="store_true",
                   help="save per-layer feature maps for the first frame")
    p.add_argument("--update", action="store_true", help="strip optimizer from --weights")
    p.add_argument("--half", action="store_true", help="accepted for parity (JAX ignores it)")
    p.add_argument("--dnn", action="store_true", help="accepted for parity (OpenCV-DNN N/A)")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--line-thickness", type=int, default=3)
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--no-fuse", dest="fuse", action="store_false",
                   help="disable conv+BN inference folding")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--soft-nms", action="store_true", help="Gaussian soft-NMS")
    p.add_argument("--augment", action="store_true", help="TTA: multi-scale + flip inference")
    p.add_argument("--vid-stride", type=int, default=1, help="video frame-rate stride")
    p.add_argument("--max-frames", type=int, default=None, help="stop streams after N frames")
    p.add_argument("--view-img", action="store_true", help="show annotated frames live")
    p.add_argument("--save-crop", action="store_true",
                   help="save per-detection crops under crops/<class>/")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
