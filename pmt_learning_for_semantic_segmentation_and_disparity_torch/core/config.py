"""The port's own configuration dataclasses.

A copy of the part of the JAX package's ``core/config.py`` that the ported
slices read (field names and defaults unchanged, so a config reads the same
in both packages). The rest (run and CLI flags) comes with the slices that
use it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

DATASET_N_LABELS = {
    "garden": 9,
    "roses": 2,
    "cityscapes": 19,
    "kitti": 19,
    "sceneflow": 19,
}


def output_type_for(net: str, hanet: bool = False, multaskloss: int = 0) -> str:
    """The reference's ``outputType`` of a net (util/utilLoadNetwork.py:28-53),
    which picks the loss and metric branches."""
    out = "smallOutSeg" if "sdnet_mini_ext" in net else ""
    if net == "sdnet_mini":
        out = "smallOutPair"
    if net == "sdnet_seg":
        out = "smallOutWarp"
    if net in ("dsnet_warp", "dsnet_warp_soft"):
        out = "ThreeOutPuts"
    if net == "dsnet_warp_disp":
        out = "ThreeOutPutsDisp"
    if net == "dsnet_warp_disp_consist":
        out = "ThreeOutPutsDispConsist"
    if "edge" in net:
        out = "edgeOut"
    if hanet:
        out = "hanet"
    if multaskloss:
        out = "multitask"
    if "deeplab" in net:
        out = net
    if net == "pspnet":
        out = "pspnet"
    return out or "two_out"


@dataclass
class DataConfig:
    dataset_name: str = "roses"

    @property
    def n_labels(self) -> int:
        return DATASET_N_LABELS[self.dataset_name]


@dataclass
class ModelConfig:
    """Model-zoo config (reference flags -net/-backbone/-corrType/...)."""

    net: str = "sdnet_mini_ext"
    backbone: str = "densenet"
    corr_type: str = "1dcorr"  # '1dcorr' | '2dcorr'
    output_activation: str = "linear"  # sigmoid | tanh | relu | linear
    edges: bool = False
    aspp: int = 0  # 0 | 1 | 2
    use_att: bool = True
    hanet: bool = False
    multaskloss: int = 0  # 0 | 1 | 2
    conv_deconv_out: int = 0  # 0 | 1 | 2
    dropout: float = 0.0
    ablation: tuple = ()  # 'no_dec1' | 'no_dec2' | 'no_dec3'
    # A TPU layout choice of the JAX package (space-to-depth decoder heads);
    # the same function either way, so the port accepts and ignores it.
    s2d_heads: bool = True

    @property
    def output_type(self) -> str:
        return output_type_for(self.net, self.hanet, self.multaskloss)

    @property
    def max_disp(self) -> float:
        """Disparity normalizer (torch_implementation.py:644-655)."""
        return 1.0 if self.output_activation == "linear" else 100.0


@dataclass
class LossConfig:
    """Loss-stack config (-loss, -segWeight; multiLosses.py:8-157)."""

    losses: Tuple[str, ...] = ("cross_entropy", "lovasz_loss")
    seg_weight: bool = False


@dataclass
class OptimConfig:
    """Optimizer config (torch_implementation.py:715-724, 599-609)."""

    optim_type: str = "adam"  # adam | sgd
    # None -> reference's rule: 5e-6 deeplab, 5e-4 if >2 losses, else 1.5e-3
    learning_rate: Optional[float] = None
    adam_eps: float = 1e-7
    sgd_momentum: float = 0.9
    sgd_weight_decay: float = 1e-4
    poly_base_lr: float = 0.005
    poly_epoch_horizon: int = 2400
    accumulate_grad: int = 1  # -acmt_grad
    freeze_bn: bool = False

    def resolve_lr(self, net: str, n_losses: int) -> float:
        if self.learning_rate is not None:
            return self.learning_rate
        if self.optim_type == "sgd":
            return self.poly_base_lr
        if net == "deeplab":
            return 5e-6
        if n_losses > 2:
            return 5e-4
        return 1.5e-3


@dataclass
class ParallelConfig:
    # mixed precision: fp32 master weights, bf16 compute
    bf16: bool = False


@dataclass
class PMTConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
