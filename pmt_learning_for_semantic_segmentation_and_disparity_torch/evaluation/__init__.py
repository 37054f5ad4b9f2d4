from .evaluator import (  # noqa: F401
    MetricAccumulator,
    dump_prediction_images,
    save_confusion_matrix_png,
)
from .tiled import tiled_inference  # noqa: F401
