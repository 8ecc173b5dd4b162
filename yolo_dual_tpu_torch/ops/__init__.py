"""Boxes, NMS and mask post-processing (JAX yolo_dual_tpu/ops).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "bbox_iou": "boxes",
    "box_iou": "boxes",
    "clip_boxes": "boxes",
    "scale_boxes": "boxes",
    "xywh2xyxy": "boxes",
    "xyxy2xywh": "boxes",
    "xywhn2xyxy": "boxes",
    "xyxy2xywhn": "boxes",
    "non_max_suppression": "nms",
    "nms_padded": "nms",
    "soft_nms_padded": "nms",
    "crop_mask": "mask_ops",
    "mask_iou": "mask_ops",
    "masks_iou": "mask_ops",
    "process_mask": "mask_ops",
    "process_mask_upsample": "mask_ops",
    "scale_image": "mask_ops",
})
