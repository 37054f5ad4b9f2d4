from .config import (  # noqa: F401
    DATASET_N_LABELS,
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    PMTConfig,
    RunConfig,
    build_arg_parser,
    config_from_args,
    output_type_for,
)
from .device import resolve_device  # noqa: F401
from .registry import BACKBONES, MODELS, Registry  # noqa: F401
