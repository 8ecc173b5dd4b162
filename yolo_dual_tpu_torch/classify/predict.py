"""Classification prediction CLI (port of classify/predict.py; reference
classify/predict.py:1-224): images in, top-k class probabilities out, with
annotated frames and optional txt rows.

    python -m yolo_dual_tpu_torch.classify.predict --weights best.pt --model yolov5s.yaml \
        --source DIR --save-txt
    python -m yolo_dual_tpu_torch.classify.predict --model resnet18 --source DIR --nosave \
        --device cpu

`--source` is an image file, a video, an RGB uint8 `.npy` frame or a
directory of them, a webcam index, a stream URL, a `.streams` list file or
"screen" (engine/predictor.py:iter_source; images, videos and streams need
cv2, the screen mss; --vid-stride and --max-frames as in segment.predict).
Each frame is center-cropped and resized on the host
(data/classify.py:classify_transforms) and its softmax's top-k is logged,
returned and, with --save-txt, written to `labels/<stem>.txt` as "prob name"
pairs (a video or stream frame's to `labels/<stem>_<frame>.txt`). The
annotated frames (the top-k as text) are saved unless --nosave, a video's or
stream's as one mp4 a source, and shown with --view-img; drawing, saving
and showing need cv2. --weights takes a `.pt` of classify.train (its EMA
weights, and its class names), or an orbax checkpoint directory of the JAX
package (its EMA first, and its `classes`); --update strips a `.pt`'s
optimizer state first, or rewrites a directory as JAX's strip_optimizer does.
Without weights the model has JAX's initial weights under PRNGKey(0) and
1000 classes.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.classify.train import build_classifier
from yolo_dual_tpu_torch.data.classify import classify_transforms
from yolo_dual_tpu_torch.engine.predictor import _cv2, iter_source, save_media_frame, source_stem
from yolo_dual_tpu_torch.io.ocdbt import OrbaxCheckpoint
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.train.checkpoint import load_checkpoint, strip_optimizer
from yolo_dual_tpu_torch.utils.general import LOGGER, increment_path, select_device
from yolo_dual_tpu_torch.utils.plots import Annotator

ROOT = Path(__file__).resolve().parents[2]


def run(weights="", model="yolov5n.yaml", source="", imgsz=224, cutoff=10, topk=5,
        device="cuda", project="runs/predict-cls", name="exp", exist_ok=False,
        save_txt=False, nosave=False, vid_stride=1, max_frames=None, view_img=False,
        update=False, **kw):
    """Predict; returns JAX's list of (path, top-k class ids, their
    probabilities), a frame each."""
    dev = select_device(device)
    cv2 = None if nosave and not view_img else _cv2("saving or showing annotated frames")
    classes, nc = None, 1000
    if weights and not str(weights).endswith(".pt"):  # an orbax checkpoint of the JAX package
        if update:
            strip_optimizer(weights)
        ckpt = OrbaxCheckpoint(weights)
        classes = [str(c) for c in ckpt.read("classes")] if ckpt.has("classes") else None
        nc = len(classes) if classes else nc
    elif weights:
        if update:
            strip_optimizer(weights)
        classes = list(load_checkpoint(weights).get("classes") or []) or None
        nc = len(classes) if classes else nc
    m = build_classifier(model, nc, cutoff=cutoff, device=dev)
    if weights:
        m.load_state_dict(resolve_state_dict(weights), strict=True)
    else:
        flax_init_(m)
    m.eval()
    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    results = []
    vid_writers = {}
    frame_idx = {}
    try:
        for path, im0, fps in iter_source(source, vid_stride=vid_stride, max_frames=max_frames):
            frame = frame_idx[path] = frame_idx.get(path, 0) + 1 if fps is not None else 0
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
                suffix = f"_{frame}" if fps is not None else ""
                txt = save_dir / "labels" / f"{source_stem(path)}{suffix}.txt"
                txt.parent.mkdir(parents=True, exist_ok=True)
                with open(txt, "a") as f:
                    f.write(" ".join(f"{prob[i]:.2f} {n}" for n, i in zip(names, order)) + "\n")
            if cv2 is not None:
                annotator = Annotator(im0.copy(), line_width=2)
                for row, (n, i) in enumerate(zip(names, order)):
                    annotator.text((8, 16 + row * 18), f"{prob[i]:.2f} {n}")
                frame_bgr = annotator.result()[..., ::-1]
                if view_img:
                    cv2.imshow(str(path), frame_bgr)
                    cv2.waitKey(1)
                if not nosave:
                    save_media_frame(save_dir, path, frame_bgr, fps, vid_writers)
    finally:
        for wtr in vid_writers.values():
            wtr.release()
    if not nosave or save_txt:
        LOGGER.info(f"results saved to {save_dir}")
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Classification prediction (PyTorch port)")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--model", type=str, default="yolov5n.yaml")
    p.add_argument("--source", type=str, required=True,
                   help="image/video/.npy file or directory, webcam index, URL, .streams, screen")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=224)
    p.add_argument("--cutoff", type=int, default=10)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--project", default=str(ROOT / "runs" / "predict-cls"))
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--save-txt", action="store_true", help="save top-k rows to labels/*.txt")
    p.add_argument("--nosave", action="store_true", help="no annotated media")
    p.add_argument("--vid-stride", type=int, default=1, help="video frame-rate stride")
    p.add_argument("--max-frames", type=int, default=None, help="stop streams after N frames")
    p.add_argument("--view-img", action="store_true", help="show annotated frames live")
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
