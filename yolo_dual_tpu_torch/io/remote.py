"""Remote-inference client (port of yolo_dual_tpu/io/remote.py; reference
utils/triton.py:11-85 TritonRemoteModel): speaks the JSON-over-HTTP protocol
of the model server (yolo_dual_tpu_torch/serve.py, or the JAX package's
serve.py). Arrays are sent as PNG through the port's own codec
(utils/png.py), so the client needs no cv2.

    rm = RemoteModel("http://gpu-host:8507")
    dets = rm(image_bgr)          # (n, 6) [x1, y1, x2, y2, conf, cls]
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np

from yolo_dual_tpu_torch.utils import png
from yolo_dual_tpu_torch.utils.general import LOGGER


class RemoteModel:
    """Client for a model server's /predict endpoint. Takes HWC uint8 images
    (BGR, as cv2 reads them: the server decodes to BGR and letterboxes the
    RGB frame; channel order only changes colours) or encoded image bytes."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        if not self.health():
            raise ConnectionError(f"remote model at {self.url} failed health check")
        LOGGER.info(f"RemoteModel: connected to {self.url}")

    def health(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self.url}/health", timeout=self.timeout) as r:
                return r.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def _encode(self, image) -> bytes:
        if isinstance(image, (bytes, bytearray)):
            return bytes(image)
        return png.encode(np.asarray(image))

    def __call__(self, image) -> np.ndarray:
        """(n, 6) float32 [x1, y1, x2, y2, conf, cls] in the original image's
        pixels (the server un-letterboxes)."""
        req = urllib.request.Request(
            f"{self.url}/predict", data=self._encode(image), method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            payload = json.loads(r.read())
        dets = payload.get("detections", [])
        if not dets:
            return np.zeros((0, 6), np.float32)
        return np.array([[*d["box"], d["conf"], d["cls"]] for d in dets], np.float32)

    def warmup(self, shape=(64, 64, 3)):
        self(np.zeros(shape, np.uint8))
        return self
