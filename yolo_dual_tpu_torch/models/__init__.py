"""The config compiler and the model wrappers (JAX yolo_dual_tpu/models).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "DetectionModel": "model",
    "SegmentationModel": "model",
    "SemanticSegModel": "model",
    "ClassificationModel": "model",
    "build_model": "model",
    "register_module": "compiler",
})
