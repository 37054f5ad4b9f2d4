from .checkpoint import CheckpointManager  # noqa: F401
from .loop import Session  # noqa: F401
from .optim import Optimizer, Transform, build_optimizer  # noqa: F401
from .state import TrainState  # noqa: F401
from .step import (  # noqa: F401
    compute_metrics,
    make_eval_step,
    make_forward_fn,
    make_loss_fn,
    make_losses_fn,
    make_train_step,
)
