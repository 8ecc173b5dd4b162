"""Validation, prediction and AutoShape (JAX yolo_dual_tpu/engine).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "evaluate_segment": "validator",
    "evaluate_semantic": "validator",
    "predict_images": "predictor",
    "AutoShape": "autoshape",
    "Detections": "autoshape",
})
