"""Detection, instance, semantic and OTA losses (JAX yolo_dual_tpu/losses).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "SemanticSegLoss": "semantic",
    "seg_labels_to_class_weights": "semantic",
    "parse_class_weights": "semantic",
    "ComputeLoss": "detect",
    "smooth_bce": "detect",
    "ComputeSegmentLoss": "segment",
    "ComputeLossOTA": "ota",
    "ComputeLossAuxOTA": "ota",
})
