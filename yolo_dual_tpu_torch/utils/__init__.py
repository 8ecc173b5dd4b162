"""Logging, config, seeding, device and timer helpers (JAX yolo_dual_tpu/utils).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "LOGGER": "general",
    "colorstr": "general",
    "check_img_size": "general",
    "increment_path": "general",
    "init_seeds": "general",
    "make_divisible": "general",
    "yaml_load": "general",
    "yaml_save": "general",
    "Profile": "general",
    "select_device": "general",
})
