"""Classification prediction CLI (port of classify/predict.py; reference
classify/predict.py:1-224): images in, top-k class probabilities out, with
annotated frames and optional txt rows.

    python -m yolo_dual_tpu_torch.classify.predict --weights best.pt --model yolov5s.yaml \
        --source DIR --save-txt
    python -m yolo_dual_tpu_torch.classify.predict --model resnet18 --source DIR --nosave \
        --device cpu

`--source` is an image file, an RGB uint8 `.npy` frame or a directory of
them (engine/predictor.py:iter_source; image files need cv2). Each frame is
center-cropped and resized on the host (data/classify.py:classify_transforms)
and its softmax's top-k is logged, returned and, with --save-txt, written to
`labels/<stem>.txt` as "prob name" pairs. The annotated frames (the top-k as
text) are saved unless --nosave; drawing and saving need cv2. --weights takes
a `.pt` of classify.train (its EMA weights, and its class names); --update
strips its optimizer state first. Without weights the model has JAX's
initial weights under PRNGKey(0) and 1000 classes. Video, stream and
screenshot sources, --vid-stride, --max-frames and --view-img are not ported
yet (ROADMAP A item 6e).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.classify.train import build_classifier
from yolo_dual_tpu_torch.data.classify import classify_transforms
from yolo_dual_tpu_torch.engine.predictor import _cv2, iter_source
from yolo_dual_tpu_torch.io.weights import load_state_dict_file
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint, strip_optimizer
from yolo_dual_tpu_torch.utils.general import LOGGER, increment_path, select_device
from yolo_dual_tpu_torch.utils.plots import Annotator

ROOT = Path(__file__).resolve().parents[2]
VID_EXTS = (".asf", ".avi", ".gif", ".m4v", ".mkv", ".mov", ".mp4", ".mpeg", ".mpg", ".ts",
            ".wmv", ".webm")


def _refuse_media(source, vid_stride, max_frames, view_img):
    s = str(source)
    media = s.isnumeric() or s.endswith(".streams") or s.lower().startswith(
        ("rtsp://", "rtmp://", "http://", "https://", "screen")) \
        or Path(s).suffix.lower() in VID_EXTS
    if media or vid_stride != 1 or max_frames is not None or view_img:
        raise NotImplementedError("classify.predict reads image files and .npy frames only: "
                                  "video, stream and screenshot sources, --vid-stride, "
                                  "--max-frames and --view-img are not ported yet "
                                  "(ROADMAP A item 6e)")


def run(weights="", model="yolov5n.yaml", source="", imgsz=224, cutoff=10, topk=5,
        device="cuda", project="runs/predict-cls", name="exp", exist_ok=False,
        save_txt=False, nosave=False, vid_stride=1, max_frames=None, view_img=False,
        update=False, **kw):
    """Predict; returns JAX's list of (path, top-k class ids, their
    probabilities), a frame each."""
    dev = select_device(device)
    _refuse_media(source, vid_stride, max_frames, view_img)
    cv2 = None if nosave else _cv2("saving annotated frames")
    classes, nc = None, 1000
    if weights:
        if update:
            strip_optimizer(weights)
        classes = list(load_checkpoint(weights).get("classes") or []) or None
        nc = len(classes) if classes else nc
    m = build_classifier(model, nc, cutoff=cutoff, device=dev)
    if weights:
        m.load_state_dict(load_state_dict_file(weights), strict=True)
    else:
        flax_init_(m)
    m.eval()
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    results = []
    for path, im0 in iter_source(source):
        im0 = np.asarray(im0)
        x = torch.from_numpy(classify_transforms(im0, imgsz)).to(dev).permute(2, 0, 1)[None]
        with torch.inference_mode():
            prob = torch.softmax(m(x).float(), -1)[0].cpu().numpy()
        order = np.argsort(-prob)[:topk]
        names = [classes[i] if classes else str(i) for i in order]
        LOGGER.info(f"{Path(path).name}: " + ", ".join(f"{n} {prob[i]:.3f}"
                                                        for n, i in zip(names, order)))
        results.append((str(path), order, prob[order]))
        if save_txt:
            txt = save_dir / "labels" / f"{Path(path).stem}.txt"
            txt.parent.mkdir(parents=True, exist_ok=True)
            with open(txt, "a") as f:
                f.write(" ".join(f"{prob[i]:.2f} {n}" for n, i in zip(names, order)) + "\n")
        if cv2 is not None:
            annotator = Annotator(im0.copy(), line_width=2)
            for row, (n, i) in enumerate(zip(names, order)):
                annotator.text((8, 16 + row * 18), f"{prob[i]:.2f} {n}")
            cv2.imwrite(str(save_dir / Path(path).name), annotator.result()[..., ::-1])
    if cv2 is not None or save_txt:
        LOGGER.info(f"results saved to {save_dir}")
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Classification prediction (PyTorch port)")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--model", type=str, default="yolov5n.yaml")
    p.add_argument("--source", type=str, required=True, help="image, .npy frame or directory")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=224)
    p.add_argument("--cutoff", type=int, default=10)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--project", default=str(ROOT / "runs" / "predict-cls"))
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--save-txt", action="store_true", help="save top-k rows to labels/*.txt")
    p.add_argument("--nosave", action="store_true", help="no annotated frames")
    p.add_argument("--vid-stride", type=int, default=1, help="not ported yet")
    p.add_argument("--max-frames", type=int, default=None, help="not ported yet")
    p.add_argument("--view-img", action="store_true", help="not ported yet")
    p.add_argument("--update", action="store_true", help="strip optimizer from --weights")
    p.add_argument("--half", action="store_true", help="parity flag")
    p.add_argument("--dnn", action="store_true", help="parity flag")
    p.add_argument("--augment", action="store_true", help="parity flag (no cls TTA upstream)")
    p.add_argument("--visualize", action="store_true", help="parity flag")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


def main(argv=None):
    return run(**vars(parse_opt(argv)))


if __name__ == "__main__":
    main()
