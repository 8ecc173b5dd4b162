"""Model export CLI (port of the JAX package's root export.py).

Usage:
    python -m yolo_dual_tpu_torch.export --weights runs/train-seg/exp/best \\
        --cfg yolov5s-seg.json --include torchpt onnx --imgsz 640

--weights is a `.pt` state_dict or an orbax checkpoint directory of the JAX
package (its EMA first; io/weights.py:resolve_state_dict); without it the
model has random weights drawn from a generator seeded with 0. A config
without anchors is a semantic one (resnet50.json), as in JAX.

  - torchpt : {"model": state_dict, "format": "yolo_dual_tpu-state_dict"},
              unfused, under the reference's names (the port's own; the
              JAX package and the reference ecosystem import it)
  - onnx    : io/onnx_export.py, the conv+BN-folded graph
  - savedmodel, tflite : JAX converts through jax2tf; the port has no
              converter from torch to TF (ROADMAP A item 7f), so they raise
              NotImplementedError, and so --fuse and --int8, which only they
              read, change nothing here (logged).

Export computes nothing on a device: the model is built on the CPU and only
its weights are written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from yolo_dual_tpu_torch.io.onnx_export import export_onnx
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.utils.general import LOGGER, find_cfg

UNPORTED = ("savedmodel", "tflite")


def export_formats():
    """The formats table: [name, --include argument, suffix, written by this
    package]."""
    return [
        ["Orbax checkpoint", "orbax", "", False],
        ["PyTorch state_dict", "torchpt", ".pt", True],
        ["ONNX", "onnx", ".onnx", True],
        ["TF SavedModel", "savedmodel", "_saved_model", False],
        ["TFLite", "tflite", ".tflite", False],
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


def run(weights="", cfg="yolov5s-seg.json", nc=None, imgsz=640, include=("torchpt",),
        out_dir="runs/export", fuse=False, int8=False) -> dict:
    """Write each format of `include` under `out_dir` as `<cfg stem><suffix>`;
    returns {format: path}."""
    unported = [f for f in include if f in UNPORTED]
    if unported:
        raise NotImplementedError(
            f"--include {' '.join(unported)}: JAX converts through jax2tf and the port has no "
            "converter from torch to TF (ROADMAP A item 7f)")
    if fuse or int8:
        LOGGER.info("--fuse and --int8 apply to SavedModel / TFLite only: the .pt stays "
                    "unfused and the ONNX graph is always folded")
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
                   help="fold conv+BN before SavedModel/TFLite export (not ported: 7f)")
    p.add_argument("--int8", action="store_true",
                   help="TFLite post-training int8 quantization (not ported: 7f)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
