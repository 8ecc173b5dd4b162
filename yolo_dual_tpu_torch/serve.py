"""Minimal HTTP model server (port of the JAX package's root serve.py).

POST a PNG (or, where cv2 is installed, any image cv2 decodes) to /predict
and get JSON back; GET /health answers "ok". The model stays resident on the
card. Two dialects, chosen by the config:

- detect / instance-seg configs (with anchors): {"detections": [{"box":
  [x1, y1, x2, y2], "conf": c, "cls": k}, ...]}, boxes in the request
  image's pixels. The frame is letterboxed on the host
  (data/augment.py:letterbox), the conv+BN-folded model runs with
  decode=False, `ops/nms.py:nms_from_raw` keeps the boxes and
  `ops/boxes.py:scale_boxes` takes them back to the frame.
- semantic configs (no anchors): {"shape": [h, w], "class_pixels": {id:
  count}, "mask_png_b64": ...}, the argmax class map cropped to the
  letterbox's content box, resized to the frame (nearest) and sent as a grey
  PNG in base64.

Status codes as JAX's: 400 for an empty body or one that does not decode
(the message names cv2 where a body that is not a PNG needs it), 404 for any
other path. The server is one thread (http.server.HTTPServer) and warms the
model up once before it answers.

Usage:
    python -m yolo_dual_tpu_torch.serve --weights best.pt --cfg yolov5s-seg-dcnv3.json --port 8507
    python -m yolo_dual_tpu_torch.serve --cfg resnet50.json --weights sem.pt --device cpu
    curl -s -X POST --data-binary @img.png localhost:8507/predict
"""

from __future__ import annotations

import argparse
import base64
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from yolo_dual_tpu_torch.data.augment import letterbox
from yolo_dual_tpu_torch.data.json_dataset import resize_nearest_u8
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.models.model import SegmentationModel, SemanticSegModel
from yolo_dual_tpu_torch.ops.boxes import scale_boxes
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.utils import png
from yolo_dual_tpu_torch.utils.general import LOGGER, find_cfg, load_config, select_device


class _Clock:
    """A request's parts: host marks (perf_counter) and, on the card, CUDA
    events around the device part."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = [time.perf_counter()]
        self.events = None

    def mark(self):
        self.marks.append(time.perf_counter())

    def device_begin(self):
        if self.cuda:
            self.events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.events[0].record()

    def device_end(self):
        if self.cuda:
            self.events[1].record()

    def parts(self, names) -> dict:
        ms = {n: (b - a) * 1e3 for n, a, b in zip(names, self.marks, self.marks[1:])}
        if self.events is not None:
            self.events[1].synchronize()
            ms["device_events_ms"] = self.events[0].elapsed_time(self.events[1])
        return ms


def build_server(opt) -> HTTPServer:
    """The HTTPServer with the model resident on `opt.device` (JAX
    serve.py:build_server). Split from main() so tests and clients can run
    it in a thread. Each answered request appends the ms of its parts to
    `server.timings`: read (the body), decode (PNG or cv2), letterbox, device
    (H2D, forward, NMS or argmax, D2H; H2D to NMS or argmax also by CUDA
    events on the card, as device_events_ms) and json (the rest: boxes back
    to the frame, or the class map's crop, resize, counts and PNG; the JSON
    and its write)."""
    dev = select_device(opt.device)
    cfg_path = find_cfg(opt.cfg)
    semantic = load_config(cfg_path).get("anchors") is None
    gen = torch.Generator().manual_seed(0)
    if semantic:
        nc = opt.nc if opt.nc is not None else int(load_config(cfg_path).get("nc", 12))
        if nc > 256:
            # the served class map is a uint8 PNG; ids above 255 would wrap
            raise SystemExit(f"semantic serving supports nc<=256 (got {nc}): "
                             "the class-map response is a uint8 PNG")
        model = SemanticSegModel(cfg_path, nc=opt.nc, device=dev, generator=gen)
    else:
        model = SegmentationModel(cfg_path, nc=opt.nc if opt.nc is not None else 80,
                                  device=dev, generator=gen)
        head = model.model[-1]
    if opt.weights:
        model.load_state_dict(resolve_state_dict(opt.weights), strict=True)
    model.eval().fuse()

    @torch.inference_mode()
    def infer(im: np.ndarray, clock: _Clock):
        """(imgsz, imgsz, 3) RGB uint8 -> the class map (imgsz, imgsz) uint8,
        or the kept rows (k, 6+nm), both on the host."""
        clock.device_begin()
        x = torch.from_numpy(im).to(dev).permute(2, 0, 1)[None].float() / 255.0
        if semantic:
            res = model(x).argmax(1)[0].to(torch.uint8)
            clock.device_end()
            return res.cpu().numpy()
        levels, _ = model(x, decode=False)
        out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=opt.conf_thres,
                               iou_thres=opt.iou_thres, max_det=opt.max_det, nm=head.nm)
        clock.device_end()
        return out[0, :int(nv[0])].cpu()

    infer(np.zeros((opt.imgsz, opt.imgsz, 3), np.uint8), _Clock(dev))  # warm-up
    LOGGER.info(f"model ready on port {opt.port} ({dev})")

    class Handler(BaseHTTPRequestHandler):
        def _json(self, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            clock = _Clock(dev)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            clock.mark()
            try:
                img = png.imdecode_color(body)
            except (ValueError, ImportError) as e:
                self.send_error(400, f"not an image: {e}")
                return
            if img is None:
                self.send_error(400, "not an image")
                return
            clock.mark()
            h0, w0 = img.shape[:2]
            im, ratio, pad = letterbox(np.ascontiguousarray(img[..., ::-1]), opt.imgsz)
            clock.mark()
            res = infer(im, clock)
            clock.mark()
            if semantic:
                # the content box as letterbox laid it out (its -0.1 rounding), the
                # class map cropped to it and resized (nearest) to the frame
                bw, bh = int(round(w0 * ratio[0])), int(round(h0 * ratio[1]))
                top, left = int(round(pad[1] - 0.1)), int(round(pad[0] - 0.1))
                full = resize_nearest_u8(res[top:top + bh, left:left + bw], h0, w0)
                ids, counts = np.unique(full, return_counts=True)
                payload = {
                    "shape": [int(h0), int(w0)],
                    "class_pixels": {int(i): int(c) for i, c in zip(ids, counts)},
                    "mask_png_b64": base64.b64encode(png.encode(full)).decode(),
                }
            else:
                boxes = scale_boxes((opt.imgsz, opt.imgsz), res[:, :4], (h0, w0)).tolist()
                payload = {"detections": [
                    {"box": [float(v) for v in b], "conf": float(c), "cls": int(cl)}
                    for b, c, cl in zip(boxes, res[:, 4].tolist(), res[:, 5].tolist())]}
            self._json(payload)
            clock.mark()
            self.server.timings.append(clock.parts(("read", "decode", "letterbox", "device",
                                                    "json")))

        def do_GET(self):
            if self.path == "/health":
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):
            LOGGER.info("serve: " + fmt % args)

    server = HTTPServer(("0.0.0.0", opt.port), Handler)
    server.timings = []
    server.model = model
    return server


def main(opt):
    build_server(opt).serve_forever()


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="", help="a .pt state_dict or an orbax checkpoint directory")
    p.add_argument("--cfg", default="yolov5s-seg.json")
    p.add_argument("--nc", type=int, default=None,
                   help="class-count override; default: the config's own nc")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--port", type=int, default=8507)
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_opt())
