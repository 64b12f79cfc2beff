"""Frame sources for live demos (reference tools/utils.py:106-243
`VideoStreamer`): webcam / IP stream / image directory / video file, with
optional resize, behind one `next_frame()` interface (a copy of
impx/tools/video.py)."""
from __future__ import annotations

import glob
import os.path as osp

import numpy as np


class VideoStreamer:
    def __init__(self, basedir, resize=None, skip: int = 1,
                 image_glob=("*.png", "*.jpg", "*.jpeg"), max_length: int = 1_000_000):
        import cv2

        self.cv2 = cv2
        self.resize = resize
        self.skip = skip
        self.i = 0
        self.cap = None
        self.listing = []

        if isinstance(basedir, int) or (isinstance(basedir, str) and basedir.isdigit()):
            self.cap = cv2.VideoCapture(int(basedir))
            self.mode = "camera"
        elif isinstance(basedir, str) and basedir.startswith(("http", "rtsp")):
            self.cap = cv2.VideoCapture(basedir)
            self.mode = "ip"
        elif osp.isdir(basedir):
            for g in image_glob:
                self.listing += glob.glob(osp.join(basedir, g))
            self.listing = sorted(self.listing)[::skip][:max_length]
            if not self.listing:
                raise IOError(f"no images found in {basedir}")
            self.mode = "images"
        elif osp.isfile(basedir):
            self.cap = cv2.VideoCapture(basedir)
            self.mode = "video"
        else:
            raise ValueError(f"cannot interpret source {basedir!r}")

    def _process(self, frame):
        if frame is None:
            return None
        if frame.ndim == 3:
            frame = self.cv2.cvtColor(frame, self.cv2.COLOR_BGR2GRAY)
        if self.resize:
            h, w = frame.shape
            scale = self.resize[0] / max(h, w)
            frame = self.cv2.resize(frame, (int(w * scale), int(h * scale)))
        return frame

    def next_frame(self):
        """Returns (frame [H,W] uint8 or None, ok)."""
        if self.mode == "images":
            if self.i >= len(self.listing):
                return None, False
            frame = self.cv2.imread(self.listing[self.i], self.cv2.IMREAD_GRAYSCALE)
            self.i += 1
            return self._process(frame), True
        ok, frame = self.cap.read()
        if not ok:
            return None, False
        if self.mode == "video" and self.skip > 1:
            for _ in range(self.skip - 1):
                self.cap.read()
        self.i += 1
        return self._process(frame), True
