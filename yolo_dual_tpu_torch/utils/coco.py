"""COCO-format prediction export: RLE mask encoding, JSON and the COCOeval
hook (port of yolo_dual_tpu/utils/coco.py; reference segment/val.py:57-88
save_one_json, :372-390 COCOeval bbox + segm).

The compressed-RLE codec is pycocotools' maskApi.c rleEncode / rleToString /
rleFrString in Python; COCOeval runs only where pycocotools is importable.
`save_one_json` also takes the masks as a torch tensor: their runs are then
found on the tensor's device (`masks_to_rles`) and only the run lengths come
to the host.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import torch

from yolo_dual_tpu_torch.utils.general import LOGGER


# ---------------------------------------------------------------------------
# Compressed RLE codec (pycocotools maskApi.c format)
# ---------------------------------------------------------------------------

def binary_mask_to_rle(mask: np.ndarray) -> Dict:
    """Encode a (h, w) binary mask as COCO compressed RLE
    ({"size": [h, w], "counts": str}), matching pycocotools.mask.encode.

    Runs are counted in column-major (Fortran) order starting with the number
    of leading zeros; counts are delta-encoded against count[i-2] for i>2 and
    packed LEB128-style in 6-bit chars offset by 48 (maskApi.c rleToString)."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    flat = mask.T.reshape(-1)  # column-major
    if flat.size == 0:
        cnts: List[int] = [0]
    else:
        change = np.flatnonzero(np.diff(flat)) + 1
        bounds = np.concatenate([[0], change, [flat.size]])
        runs = np.diff(bounds).tolist()
        cnts = ([0] + runs) if flat[0] == 1 else runs
    return {"size": [int(h), int(w)], "counts": _rle_counts_to_string(cnts)}


def masks_to_rles(masks: torch.Tensor) -> List[Dict]:
    """binary_mask_to_rle of each of the (n, h, w) masks, the runs found on
    the masks' device: the column-major pixels' change points, one transfer."""
    n, h, w = masks.shape
    flat = masks.bool().transpose(1, 2).reshape(n, h * w)
    edge = torch.ones((n, 1), dtype=torch.bool, device=flat.device)
    change = torch.cat([edge, flat[:, 1:] != flat[:, :-1], edge], 1)
    first = flat[:, 0].cpu().tolist() if h * w else [False] * n
    rows, cols = (t.cpu().numpy() for t in change.nonzero(as_tuple=True))
    bounds = np.split(cols, np.searchsorted(rows, np.arange(1, n)))
    out = []
    for b, f in zip(bounds, first):
        runs = np.diff(b).tolist() if h * w else [0]
        out.append({"size": [int(h), int(w)],
                    "counts": _rle_counts_to_string(([0] + runs) if f else runs)})
    return out


def _rle_counts_to_string(cnts: List[int]) -> str:
    s = []
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5  # Python's >> on negatives is arithmetic, like C's signed shift
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def rle_string_to_counts(s: str) -> List[int]:
    """Inverse of _rle_counts_to_string (maskApi.c rleFrString)."""
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)  # sign extension
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_to_binary_mask(rle: Dict) -> np.ndarray:
    """Decode COCO RLE (compressed string or raw counts list) to (h, w) uint8."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = rle_string_to_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major layout


def coco80_to_coco91_class() -> List[int]:
    """80-index (model) -> 91-index (COCO paper) category ids
    (reference utils/general.py coco80_to_coco91_class)."""
    return [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
            21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
            41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
            59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
            80, 81, 82, 84, 85, 86, 87, 88, 89, 90]


def save_one_json(jdict: List[dict], path, boxes_xyxy: np.ndarray, scores: np.ndarray,
                  classes: np.ndarray, pred_masks: Optional[np.ndarray] = None,
                  class_map: Optional[List[int]] = None):
    """Append one image's predictions in COCO results format
    (reference segment/val.py:67-88 save_one_json).

    boxes_xyxy (n, 4) in native pixel space; pred_masks (n, H0, W0) binary,
    a numpy array or a torch tensor."""
    stem = Path(path).stem
    image_id = int(stem) if stem.isnumeric() else stem
    box = boxes_xyxy.copy().astype(np.float64)
    wh = box[:, 2:4] - box[:, :2]
    box[:, 2:4] = wh                       # xyxy -> xywh (top-left + size)
    rles = None
    if isinstance(pred_masks, torch.Tensor) and len(pred_masks):
        rles = masks_to_rles(pred_masks)
    elif pred_masks is not None and len(pred_masks):
        rles = [binary_mask_to_rle(m) for m in np.asarray(pred_masks)]
    for i in range(len(box)):
        entry = {
            "image_id": image_id,
            "category_id": (class_map[int(classes[i])] if class_map
                            else int(classes[i])),
            "bbox": [round(float(x), 3) for x in box[i]],
            "score": round(float(scores[i]), 5),
        }
        if rles is not None:
            entry["segmentation"] = rles[i]
        jdict.append(entry)


def write_predictions_json(jdict: List[dict], save_dir, name: str = "predictions.json") -> Path:
    out = Path(save_dir) / name
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(jdict, f)
    LOGGER.info(f"saved {len(jdict)} predictions to {out}")
    return out


def evaluate_coco_json(pred_json, anno_json):
    """pycocotools COCOeval bbox+segm (reference segment/val.py:372-390).
    Returns (box_map50_95, box_map50, mask_map50_95, mask_map50) or None when
    pycocotools is unavailable."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        LOGGER.info("pycocotools not installed; skipping COCOeval "
                    "(predictions.json is still written and loadable)")
        return None
    anno = COCO(str(anno_json))
    pred = anno.loadRes(str(pred_json))
    out = []
    for task in ("bbox", "segm"):
        ev = COCOeval(anno, pred, task)
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        out += [ev.stats[0], ev.stats[1]]  # mAP50-95, mAP50
    return tuple(out)
