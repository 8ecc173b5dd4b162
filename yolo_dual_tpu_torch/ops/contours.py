"""Outer contours of a binary mask, as
`cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]`
gives them, in numpy and Python (the GPU machine has no cv2).

OpenCV's border following (Suzuki and Abe, 1985): the mask gets an implicit
one-pixel frame of zeros; a raster scan starts an outer border at each pixel
of value 1 whose left neighbour is 0, unless the last border pixel left of it
on its row carries a positive mark (the pixel then lies inside an object, in
one of its holes); holes are never traced. The follower starts at that pixel
with the first nonzero neighbour found clockwise from up-left, then turns
counter-clockwise round each border pixel from the one it came from, and
stops when it is about to repeat its first step. A traced pixel is marked -126
("nbd | -128") where its right neighbour was looked at and found 0, else 2.
CHAIN_APPROX_SIMPLE keeps a point where the direction of the next step
differs from the last one's, so only the ends of horizontal, vertical and
diagonal runs are kept. cv2 returns the contours last found first.
"""

from __future__ import annotations

from typing import List

import numpy as np

# OpenCV's chain codes: 0 right, 1 up-right, 2 up, 3 up-left, 4 left, 5 down-left,
# 6 down, 7 down-right (x right, y down)
CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
MARK_RIGHT = 130  # OpenCV's (schar)(2 | -128) = -126, stored unsigned
MARK = 2


def _trace(img: bytearray, step: int, i0: int, x: int, y: int) -> np.ndarray:
    """Follow the outer border from flat index `i0` (pixel (x, y) of the
    mask) through the padded mask `img` (row stride `step`), marking its
    pixels, and return the CHAIN_APPROX_SIMPLE points (n, 2) as (x, y)."""
    deltas = [CODE_DX[s] + CODE_DY[s] * step for s in range(8)] * 2
    s = 4
    while True:                       # clockwise from up-left: the last pixel of the border
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == 4:
            break
    if img[i1] == 0:                  # a lone pixel
        img[i0] = MARK_RIGHT
        return np.array([[x, y]], np.int32)
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while True:                   # counter-clockwise from the pixel we came from
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:        # the right neighbour was 0
            img[i3] = MARK_RIGHT
        elif img[i3] == 1:
            img[i3] = MARK
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += CODE_DX[s]
        y += CODE_DY[s]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.array(pts, np.int32)


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer contours of the nonzero pixels of a 2-D mask, each (n, 2)
    int32 (x, y) points, in cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)'s order and point order."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {m.shape}")
    h, w = m.shape
    pad = np.zeros((h + 2, w + 2), np.uint8)
    pad[1:-1, 1:-1] = m != 0
    # run starts: value 1 right of a 0, in raster order
    ys, xs = np.nonzero(pad[1:-1, 1:-1] & (pad[1:-1, :-2] == 0))
    if not len(ys):
        return []
    img = bytearray(pad.tobytes())
    view = np.frombuffer(img, np.uint8).reshape(h + 2, w + 2)   # shares img's memory
    step = w + 2
    contours = []
    for y, x in zip(ys.tolist(), xs.tolist()):
        i0 = (y + 1) * step + x + 1
        if img[i0] != 1:              # on a border traced already
            continue
        row = view[y + 1, 1:x + 1]
        marked = np.flatnonzero(row >= MARK)
        if len(marked) and row[marked[-1]] == MARK:   # inside an object: a hole's content
            continue
        contours.append(_trace(img, step, i0, x, y))
    return contours[::-1]
