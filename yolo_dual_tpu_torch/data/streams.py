"""Streaming input sources: webcam / RTSP / HTTP streams and screenshots
(port of yolo_dual_tpu/data/streams.py; reference
utils/dataloaders.py:339-420 LoadStreams: one daemon reader thread per
source holding the latest frame, fps probe, stride-synced yield; :189-235
LoadScreenshots via mss).

cv2 decodes the streams and mss grabs the screen; where either is missing
the loader raises an ImportError that names it. Frames are BGR, as cv2 and
the JAX package give them.
"""

from __future__ import annotations

import math
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

from yolo_dual_tpu_torch.utils.general import LOGGER


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("stream sources (webcam index, rtsp/rtmp/http/tcp URL, .streams "
                          "file) need OpenCV (cv2), which is not installed") from e
    return cv2


def is_stream_source(source) -> bool:
    s = str(source)
    return (s.isnumeric() or s.endswith(".streams")
            or s.lower().startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://")))


def is_screenshot_source(source) -> bool:
    s = str(source).lower()
    return s == "screen" or s.startswith("screen ")


class LoadStreams:
    """Threaded multi-stream reader (reference utils/dataloaders.py:339-420).

    Iterating yields (paths, frames) with the newest frame per source; a
    daemon thread per stream keeps `self.imgs` fresh so slow consumers drop
    frames instead of lagging (the reference's `self.imgs[i] = im` loop)."""

    def __init__(self, sources="0", vid_stride: int = 1):
        cv2 = _cv2()
        self.vid_stride = vid_stride
        src = Path(str(sources))
        if src.suffix == ".streams" and src.is_file():
            sources = [s.strip() for s in src.read_text().splitlines() if s.strip()]
        else:
            sources = [str(sources)]
        self.sources = sources
        n = len(sources)
        self.imgs: List[np.ndarray] = [None] * n
        self.fps = [0.0] * n
        self.frames = [0] * n
        self.threads = [None] * n
        self.caps = [None] * n
        self.running = True
        for i, s in enumerate(sources):
            s_ = int(s) if s.isnumeric() else s  # local webcam index or URL
            cap = cv2.VideoCapture(s_)
            assert cap.isOpened(), f"Failed to open {s}"
            self.caps[i] = cap
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            fps = cap.get(cv2.CAP_PROP_FPS)
            self.frames[i] = max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0) or float("inf")
            self.fps[i] = max((fps if math.isfinite(fps) else 0) % 100, 0) or 30
            ok, self.imgs[i] = cap.read()
            assert ok, f"Failed to read from {s}"
            # pass the PARSED source: a numeric webcam index must reopen as an
            # index — cv2 treats the string "0" as a filename and reconnection
            # would fail forever
            self.threads[i] = threading.Thread(target=self._update, args=(i, cap, s_),
                                               daemon=True)
            LOGGER.info(f"stream {i + 1}/{n}: {s} ({w}x{h} at {self.fps[i]:.0f} FPS)")
            self.threads[i].start()

    def _update(self, i, cap, stream):
        n, f = 0, self.frames[i]
        while self.running and cap.isOpened() and n < f:
            n += 1
            cap.grab()
            if n % self.vid_stride == 0:
                ok, im = cap.retrieve()
                if ok:
                    self.imgs[i] = im
                else:
                    LOGGER.warning(f"stream {stream}: frame read failed, reconnecting...")
                    self.imgs[i] = np.zeros_like(self.imgs[i])
                    cap.open(stream)
            time.sleep(0.0)

    def close(self):
        self.running = False
        for t in self.threads:
            if t is not None and t.is_alive():
                t.join(timeout=1.0)
        for cap in self.caps:
            if cap is not None:
                cap.release()

    def __iter__(self):
        self.count = -1
        return self

    def __next__(self):
        self.count += 1
        if not all(t.is_alive() for t in self.threads):
            self.close()
            raise StopIteration
        return list(self.sources), [im.copy() for im in self.imgs]

    def __len__(self):
        return len(self.sources)


class LoadScreenshots:
    """Screen-region capture via mss (reference utils/dataloaders.py:189-235).
    source: 'screen [screen_number [left top width height]]'."""

    def __init__(self, source="screen"):
        try:
            import mss
        except ImportError as e:
            raise ImportError("screenshot source requires the `mss` package, which is not "
                              "installed") from e
        parts = str(source).split()
        self.screen = int(parts[1]) if len(parts) > 1 else 0
        self.sct = mss.mss()
        mon = self.sct.monitors[self.screen]
        if len(parts) > 5:
            left, top, w, h = (int(x) for x in parts[2:6])
            self.monitor = {"left": mon["left"] + left, "top": mon["top"] + top,
                            "width": w, "height": h}
        else:
            self.monitor = mon
        self.frame = 0

    def __iter__(self):
        return self

    def __next__(self):
        im = np.asarray(self.sct.grab(self.monitor))[:, :, :3]  # BGRA -> BGR
        self.frame += 1
        return [f"screen{self.screen}"], [np.ascontiguousarray(im)]
