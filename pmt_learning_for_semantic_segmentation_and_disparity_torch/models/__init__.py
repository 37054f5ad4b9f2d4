"""Model zoo + factory (the ported part: ``sdnet_mini_ext`` with 1dcorr or
2dcorr, ``sdnet_mini``, ``sdnet`` and ``sdnetv2``, all on densenet121)."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..core.registry import BACKBONES, MODELS  # noqa: F401

# importing registers the factories
from . import densenet  # noqa: F401
from . import sdnet  # noqa: F401
from . import sdnet_legacy  # noqa: F401
from .blocks import (  # noqa: F401
    Conv2DownUp,
    ConvBN,
    ConvOut,
    DeconvBN,
    SameConvTranspose2d,
    init_parameters,
)
from .jax_weights import load_jax_variables  # noqa: F401
from .pyramid import PiramidNet2, PiramidNetV1  # noqa: F401
from .sdnet import MiniDSNet, MiniDSNetExt, SegNetHead  # noqa: F401
from .sdnet_legacy import DSNet, DSNetV2  # noqa: F401


def get_network(cfg: PMTConfig, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> torch.nn.Module:
    """Build the configured model in eval mode on ``device`` (the card by
    default; raises without one unless ``device="cpu"``), with random weights
    drawn from ``torch.Generator().manual_seed(seed)`` by the JAX package's
    initialisers. The same seed gives the same weights on every device."""
    device = resolve_device(device)
    if cfg.model.net not in MODELS:
        raise NotImplementedError(f"net {cfg.model.net!r} is not ported yet "
                                  f"(ROADMAP.md queue 1, item 12)")
    with torch.device("meta"):
        model = MODELS.get(cfg.model.net)(cfg.model, labels=cfg.data.n_labels)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
