"""Datasets and the host-to-device input pipeline (JAX yolo_dual_tpu/data).

The names load lazily (`_lazy.py`): importing the package imports none of
its modules."""

from yolo_dual_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "YoloDataset": "dataset",
    "create_dataloader": "dataset",
    "JSONSegmentDataset": "json_dataset",
    "create_json_segment_dataloader": "json_dataset",
    "mask_to_json": "json_dataset",
    "batch_convert_masks_to_json": "json_dataset",
    "verify_json_masks": "json_dataset",
    "Loader": "loader",
})
