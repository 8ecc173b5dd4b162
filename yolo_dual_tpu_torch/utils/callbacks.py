"""Callback registry for training events (port of yolo_dual_tpu/utils/callbacks.py;
reference utils/callbacks.py:9-77): the 19 named hooks, register_action and
run. Dispatch is synchronous unless `threaded=True`, the reference's
fire-and-forget option for sinks that wait on I/O."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

HOOKS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start", "on_val_batch_start", "on_val_image_end",
    "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end",
    "on_params_update", "teardown",
]


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}
        self.stop_training = False

    def register_action(self, hook: str, name: str = "", callback: Callable = None):
        assert hook in self._callbacks, f"hook '{hook}' not in {list(self._callbacks)}"
        assert callable(callback), f"callback '{callback}' is not callable"
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook=None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, threaded: bool = False, **kwargs):
        assert hook in self._callbacks, f"hook '{hook}' not in {list(self._callbacks)}"
        for logger in self._callbacks[hook]:
            if threaded:
                threading.Thread(target=logger["callback"], args=args, kwargs=kwargs,
                                 daemon=True).start()
            else:
                logger["callback"](*args, **kwargs)
