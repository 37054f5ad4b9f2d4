"""The main path's losses (the JAX package's ``losses/``), NHWC tensors."""
from .disp import masked_l1  # noqa: F401
from .dispatch import compose_disp_loss, compose_seg_loss, seg_class_weights  # noqa: F401
from .lovasz import lovasz_softmax  # noqa: F401
from .ohem import ohem_cross_entropy  # noqa: F401
from .seg import categorical_cross_entropy, class_weight_map, pick_class  # noqa: F401
from .tversky import focal_binary_tversky, multi_tversky_loss  # noqa: F401
