"""The trainer, optimizer groups, EMA and checkpoints (JAX yolo_dual_tpu/train).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "smart_optimizer": "optim",
    "build_lr_schedule": "optim",
    "freeze_layers": "optim",
    "ModelEMA": "ema",
    "Trainer": "trainer",
    "TrainState": "trainer",
    "EarlyStopping": "trainer",
    "save_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint",
    "strip_optimizer": "checkpoint",
})
