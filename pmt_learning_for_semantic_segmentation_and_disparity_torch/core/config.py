"""The port's own configuration dataclasses.

A copy of the part of the JAX package's ``core/config.py`` that the ported
slice reads (field names and defaults unchanged, so a config reads the same
in both packages). The rest (losses, optimizer, run and CLI flags) comes with
the slices that use it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

DATASET_N_LABELS = {
    "garden": 9,
    "roses": 2,
    "cityscapes": 19,
    "kitti": 19,
    "sceneflow": 19,
}


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
    def max_disp(self) -> float:
        """Disparity normalizer (torch_implementation.py:644-655)."""
        return 1.0 if self.output_activation == "linear" else 100.0


@dataclass
class ParallelConfig:
    # mixed precision: fp32 master weights, bf16 compute
    bf16: bool = False


@dataclass
class PMTConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
