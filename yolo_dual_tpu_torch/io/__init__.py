"""Weights in and out: reference `.pt` files, orbax checkpoints, MultiBackend,
Ensemble, the HTTP client (JAX yolo_dual_tpu/io).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "import_torch_state_dict": "torch_import",
    "load_torch_checkpoint": "torch_import",
    "Ensemble": "ensemble",
    "attempt_load": "ensemble",
    "MultiBackend": "multibackend",
    "detect_kind": "multibackend",
    "RemoteModel": "remote",
})
