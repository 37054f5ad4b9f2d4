from .config import (  # noqa: F401
    DATASET_N_LABELS,
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    PMTConfig,
)
from .device import resolve_device  # noqa: F401
from .registry import BACKBONES, MODELS, Registry  # noqa: F401
