"""The losses of the JAX package's ``losses/``, NHWC tensors."""
from .disp import masked_l1, photo_consistency, smoothing_gradients  # noqa: F401
from .dispatch import compose_disp_loss, compose_seg_loss, seg_class_weights  # noqa: F401
from .edge import balanced_edge_bce, dual_task_loss  # noqa: F401
from .lovasz import lovasz_softmax  # noqa: F401
from .multitask import multitask_loss  # noqa: F401
from .ohem import ohem_cross_entropy  # noqa: F401
from .seg import (  # noqa: F401
    area_ce_loss,
    area_hinge_loss,
    binary_ce,
    categorical_cross_entropy,
    categorical_nll,
    class_weight_map,
    dice_entropy,
    dice_loss,
    pick_class,
    tversky_loss2,
)
from .tversky import focal_binary_tversky, multi_tversky_loss  # noqa: F401
