"""Model export CLI (port of the JAX package's root export.py).

Usage:
    python -m yolo_dual_tpu_torch.export --weights runs/train-seg/exp/best \
        --cfg yolov5s-seg.json --include torchpt onnx savedmodel tflite --imgsz 640

--weights is a `.pt` state_dict or an orbax checkpoint directory of the JAX
package (its EMA first; io/weights.py:resolve_state_dict); without it the
model has random weights drawn from a generator seeded with 0. A config
without anchors is a semantic one (resnet50.json), as in JAX.

  - torchpt    : {"model": state_dict, "format": "yolo_dual_tpu-state_dict"},
                 unfused, under the reference's names (the port's own; the
                 JAX package and the reference ecosystem import it)
  - onnx       : io/onnx_export.py, the conv+BN-folded graph
  - savedmodel : `<stem>_saved_model/`, io/savedmodel.py: `.f(x)` on NHWC
                 float32 (1, imgsz, imgsz, 3) gives {"pred", "protos"}; its
                 BatchNorms kept, or folded with --fuse
  - tflite     : `<stem>.tflite`, io/tflite.py, conv+BN folded (as TF's
                 converter folds them); --int8 quantises it after training,
                 calibrated on JAX's 16 random frames (or `rep_images`) with
                 the graph run on `device`, float input and output

SavedModel and TFLite take Segment models only, as JAX's export_savedmodel
does (it unpacks pred, protos, _ from the forward; a Detect or semantic
model raises ValueError there, and here). yolov5s-seg-dcnv3's DCNv3 layers
are lowered to gathers (io/tf_graph.py). The writers need neither
TensorFlow, flatbuffers nor protobuf. The model is built on the CPU; only
the int8 calibration runs on a device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from yolo_dual_tpu_torch.io.onnx_export import export_onnx
from yolo_dual_tpu_torch.io.savedmodel import write_savedmodel
from yolo_dual_tpu_torch.io.tf_graph import build_tf_graph
from yolo_dual_tpu_torch.io.tflite import calibrate, representative, write_tflite
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.utils.general import LOGGER, find_cfg, select_device


def export_formats():
    """The formats table: [name, --include argument, suffix, written by this
    package]."""
    return [
        ["Orbax checkpoint", "orbax", "", True],
        ["PyTorch state_dict", "torchpt", ".pt", True],
        ["ONNX", "onnx", ".onnx", True],
        ["TF SavedModel", "savedmodel", "_saved_model", True],
        ["TFLite", "tflite", ".tflite", True],
    ]


def load_model(weights, cfg, nc=None):
    """The model of `cfg` on the CPU (build_model: semantic without anchors,
    else detect or segment by the head), --nc overriding the config's class
    count, with `weights` loaded strictly where given."""
    model = build_model(find_cfg(cfg), nc=nc, device="cpu")
    if weights:
        model.load_state_dict(resolve_state_dict(weights), strict=True)
    return model.eval()


def export_torchpt(model, out: Path) -> Path:
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "format": "yolo_dual_tpu-state_dict"}, out)
    LOGGER.info(f"exported torch state_dict -> {out}")
    return out


def _segment_only(model):
    """JAX's export_savedmodel unpacks `pred, protos, _` from the forward
    (export.py:76), so a model whose forward gives fewer values raises there."""
    head = model.spec.layers[-1].name
    if head != "Segment":
        n = 2 if head in ("Detect", "DetectAux") else 1
        raise ValueError(
            f"SavedModel and TFLite export take Segment models; this {head if n == 2 else 'semantic'} "
            f"model's forward gives {n} value{'s' * (n > 1)}, and JAX's export_savedmodel, which "
            f"unpacks (pred, protos, _), raises 'not enough values to unpack (expected 3, "
            f"got {n})'")


def export_savedmodel(model, imgsz: int, out: Path, fuse: bool = False) -> Path:
    """JAX's export_savedmodel: `out` as a SavedModel whose `.f` maps NHWC
    float32 (1, imgsz, imgsz, 3) to {"pred", "protos"}."""
    _segment_only(model)
    out = write_savedmodel(build_tf_graph(model, imgsz, fuse=fuse), out)
    LOGGER.info(f"exported SavedModel -> {out}")
    return out


def export_tflite(model, imgsz: int, out: Path, int8: bool = False, rep_images=None,
                  device="cuda") -> Path:
    """JAX's export_tflite: float32, or with `int8` full-integer quantised
    after training, activation ranges calibrated on `rep_images` (HWC or
    NHWC, uint8 or float) or JAX's 16 random frames, the graph run on
    `device`; float input and output either way."""
    _segment_only(model)
    g = build_tf_graph(model, imgsz, fuse=True)
    ranges = calibrate(g, representative(rep_images, imgsz), select_device(device)) if int8 else None
    out = write_tflite(g, out, ranges)
    LOGGER.info(f"exported TFLite{' int8' if int8 else ''} -> {out}")
    return out


def run(weights="", cfg="yolov5s-seg.json", nc=None, imgsz=640, include=("torchpt",),
        out_dir="runs/export", fuse=False, int8=False, device="cuda") -> dict:
    """Write each format of `include` under `out_dir` as `<cfg stem><suffix>`
    (tflite also writes the SavedModel, as JAX's converts from it); returns
    {format: path}. `device` runs the int8 calibration."""
    model = load_model(weights, cfg, nc)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(cfg).stem
    results = {}
    if "torchpt" in include:
        results["torchpt"] = export_torchpt(model, out_dir / f"{stem}.pt")
    if "onnx" in include:
        results["onnx"] = export_onnx(model, imgsz, out_dir / f"{stem}.onnx")
        LOGGER.info(f"exported ONNX -> {results['onnx']}")
    if "savedmodel" in include or "tflite" in include:
        results["savedmodel"] = export_savedmodel(model, imgsz, out_dir / f"{stem}_saved_model",
                                                  fuse)
        if "tflite" in include:
            results["tflite"] = export_tflite(model, imgsz, out_dir / f"{stem}.tflite", int8,
                                              device=device)
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Model export (PyTorch port)")
    p.add_argument("--weights", type=str, default="",
                   help="a .pt state_dict or an orbax checkpoint directory of the JAX package")
    p.add_argument("--cfg", type=str, default="yolov5s-seg.json")
    p.add_argument("--nc", type=int, default=None,
                   help="class-count override; default: the config's own nc")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--include", nargs="+", default=["torchpt"],
                   choices=["torchpt", "savedmodel", "tflite", "onnx"])
    p.add_argument("--out-dir", default="runs/export")
    p.add_argument("--fuse", action="store_true",
                   help="fold conv+BN before SavedModel/TFLite export")
    p.add_argument("--int8", action="store_true",
                   help="TFLite post-training int8 quantization (float IO)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
