"""Multi-backend inference loader (port of yolo_dual_tpu/io/multibackend.py;
reference models/common.py:320-624 DetectMultiBackend).

    mb = MultiBackend("runs/train-seg/exp/best", cfg="yolov5s-seg-dcnv3.json")  # on cuda
    pred, protos = mb(x)        # x: (b, 3, h, w) float in [0, 1]

One `forward` over every format this ecosystem writes:

- `orbax`: a checkpoint directory of the JAX package (io/ocdbt.py, no JAX),
  and `torchpt`: a `.pt` state_dict (export.py, the reference, the trainers):
  the port's model of `cfg`, its weights by io/weights.py:resolve_state_dict
  (the EMA first), conv+BN-folded unless fuse=False, on `device` ("cuda"
  unless the caller asks for the CPU). A `C3_DCNV3` config runs through the
  DCNv3 sampling kernel on the card.
- `torchscript`: `torch.jit.load` on `device`.
- `onnx`: OpenCV-DNN (`cv2.dnn.readNetFromONNX`, the reference's --dnn
  path) on the host; files from export.py --include onnx.
- `savedmodel`, `tflite`: the JAX package's export.py files through
  tensorflow on the host; where tensorflow is not installed they raise
  ImportError.

The contract is the reference's, in the port's layout: an NCHW float tensor
in [0, 1] goes in; (pred, protos | None) comes out as tensors, protos NCHW.
A Detect head gives protos None (its raw levels are not protos), and a
semantic graph gives its dense (b, nc, h, w) map as pred. The host backends
return CPU tensors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import build_model
from yolo_dual_tpu_torch.utils.general import LOGGER, select_device


def detect_kind(w: Path) -> str:
    """Classify a weights path as JAX's detect_kind does: files by suffix
    (.torchscript, .pt, .tflite, .onnx), a directory holding saved_model.pb
    as a SavedModel, any other directory as an orbax checkpoint."""
    s = str(w).lower()
    if s.endswith(".torchscript"):
        return "torchscript"
    if s.endswith(".pt"):
        return "torchpt"
    if s.endswith(".tflite"):
        return "tflite"
    if s.endswith(".onnx"):
        return "onnx"
    if w.is_dir():
        if (w / "saved_model.pb").exists():
            return "savedmodel"
        return "orbax"
    raise ValueError(f"unsupported weights {w}")


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("SavedModel and TFLite weights run through tensorflow, "
                          "which is not installed") from e
    return tf


def _nchw(protos: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(protos).transpose(0, 3, 1, 2)))


class MultiBackend:
    def __init__(self, weights, cfg=None, nc: int = 80, imgsz: int = 640, fuse: bool = True,
                 device="cuda"):
        w = Path(str(weights))
        self.kind = detect_kind(w)
        self.imgsz = imgsz
        self.device = torch.device("cpu")
        if self.kind in ("orbax", "torchpt"):
            if cfg is None:
                raise ValueError("cfg is required for orbax and .pt weights")
            self.device = select_device(device)
            self.model = build_model(cfg, nc=nc, device=self.device)
            self.model.load_state_dict(resolve_state_dict(w, self.model), strict=True)
            self.model.eval()
            if fuse:
                self.model.fuse()
        elif self.kind == "torchscript":
            self.device = select_device(device)
            self.ts_model = torch.jit.load(str(w), map_location=self.device).eval()
        elif self.kind == "onnx":
            import cv2
            self.net = cv2.dnn.readNetFromONNX(str(w))
            self._onnx_outs = list(self.net.getUnconnectedOutLayersNames())
        elif self.kind == "savedmodel":
            self.tf_model = _tensorflow().saved_model.load(str(w))
        elif self.kind == "tflite":
            self.interpreter = _tensorflow().lite.Interpreter(model_path=str(w))
            self.interpreter.allocate_tensors()
            self._tfl_in = self.interpreter.get_input_details()
            self._tfl_out = self.interpreter.get_output_details()
        LOGGER.info(f"MultiBackend: loaded {weights} as {self.kind}")

    @torch.inference_mode()
    def forward(self, x: torch.Tensor):
        """(b, 3, h, w) float in [0, 1] -> (pred, protos | None)."""
        if self.kind in ("orbax", "torchpt"):
            out = self.model(x.to(self.device, torch.float32))
            if not isinstance(out, tuple):
                return out, None      # semantic: one dense (b, nc, h, w) map
            if len(out) == 3:
                return out[0], out[1]  # Segment: (pred, protos, raw)
            return out[0], None       # Detect: (pred, raw levels), not protos
        if self.kind == "torchscript":
            out = self.ts_model(x.to(self.device, torch.float32))
            if isinstance(out, (list, tuple)):
                protos = out[1] if len(out) > 1 else None
                if isinstance(protos, (list, tuple)):  # torch (pred, (..., protos)) nests
                    protos = protos[-1]
                return out[0], protos
            return out, None
        xs = x.detach().to("cpu", torch.float32).numpy()
        if self.kind == "onnx":
            self.net.setInput(xs, "images")
            names = [n for n in ("pred", "protos") if n in self._onnx_outs] or self._onnx_outs
            outs = [torch.from_numpy(o) for o in self.net.forward(names)]
            return outs[0], (outs[1] if len(outs) > 1 else None)
        nhwc = np.ascontiguousarray(xs.transpose(0, 2, 3, 1))
        if self.kind == "savedmodel":
            out = self.tf_model.f(_tensorflow().constant(nhwc))
            return torch.from_numpy(np.asarray(out["pred"])), _nchw(out["protos"])
        interp = self.interpreter  # tflite
        if tuple(self._tfl_in[0]["shape"]) != nhwc.shape:
            interp.resize_tensor_input(self._tfl_in[0]["index"], nhwc.shape)
            interp.allocate_tensors()
            self._tfl_in = interp.get_input_details()
            self._tfl_out = interp.get_output_details()
        interp.set_tensor(self._tfl_in[0]["index"], nhwc)
        interp.invoke()
        # JAX's export.py writes pred (b, N, no) of rank 3 and, for a
        # segment model, protos (b, mh, mw, nm) of rank 4: told apart by rank
        outs = sorted((interp.get_tensor(d["index"]) for d in self._tfl_out), key=np.ndim)
        return torch.from_numpy(outs[0]), (_nchw(outs[1]) if len(outs) >= 2 else None)

    __call__ = forward

    def warmup(self, shape=None):
        """One forward of zeros, (1, 3, imgsz, imgsz) unless `shape` is given."""
        self.forward(torch.zeros(shape or (1, 3, self.imgsz, self.imgsz), device=self.device))
        return self
