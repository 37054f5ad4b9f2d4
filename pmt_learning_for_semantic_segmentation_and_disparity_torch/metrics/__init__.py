from .dispmetrics import DispBatchMetrics, disp_metrics, disparity_error_count  # noqa: F401
from .segmetrics import (  # noqa: F401
    SegBatchMetrics,
    branch_prf1,
    confusion_matrix,
    pixel_accuracy_from_preds,
    seg_batch_metrics,
)
