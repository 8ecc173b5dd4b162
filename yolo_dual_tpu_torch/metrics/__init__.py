from yolo_dual_tpu_torch.metrics.ap import (  # noqa: F401
    ConfusionMatrix,
    ap_per_class,
    compute_ap,
    fitness,
    smooth,
)
from yolo_dual_tpu_torch.metrics.seg import (  # noqa: F401
    IOUV,
    Metric,
    Metrics,
    SegmentationConfusionMatrix,
    ap_per_class_box_and_mask,
    fitness_seg,
    match_predictions,
    match_predictions_device,
)
