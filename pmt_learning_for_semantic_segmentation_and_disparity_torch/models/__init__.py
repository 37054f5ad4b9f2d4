"""Model zoo + factory: every net of ``VALID_NETS`` (the flagship family
``sdnet_mini_ext``/``_v2``/``_piramid``/``_piramid_res`` on every trunk of
``VALID_BACKBONES``, the Ext_small nets, ``sdnet_mini_ext_dlab``,
``sdnet_mini``, ``sdnet``, ``sdnetv2``, the warp nets and ``sdnet_seg``, the
deeplab nets, ``pspnet``), and ``EncoderDecoderNet`` (``models/encdec.py``),
which, as in the JAX package, the CLI does not reach: it is built directly."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..core.registry import BACKBONES, MODELS  # noqa: F401

# importing registers the factories
from . import deeplab  # noqa: F401
from . import densenet  # noqa: F401
from . import efficientnet  # noqa: F401
from . import ext_small  # noqa: F401
from . import mobilenetv3  # noqa: F401
from . import psmnet  # noqa: F401
from . import resnet_deeplab  # noqa: F401
from . import sdnet  # noqa: F401
from . import sdnet_dlab  # noqa: F401
from . import sdnet_legacy  # noqa: F401
from . import warpnets  # noqa: F401
from .blocks import (  # noqa: F401
    Conv2DownUp,
    ConvBN,
    ConvOut,
    DeconvBN,
    SameConvTranspose2d,
    init_parameters,
    set_batch_norm_group,
)
from .jax_weights import load_jax_variables  # noqa: F401
from .deeplab import SPPNetMono, SPPNetStereo, Xception65  # noqa: F401
from .encdec import EncoderDecoderNet  # noqa: F401
from .psmnet import PSMNet  # noqa: F401
from .pyramid import PiramidNet2, PiramidNet2Warp, PiramidNetV1  # noqa: F401
from .ext_small import ExtSmall  # noqa: F401
from .sdnet import MiniDSNet, MiniDSNetExt, SegNetHead  # noqa: F401
from .sdnet_dlab import MiniDSNetExtDeeplab  # noqa: F401
from .sdnet_legacy import DSNet, DSNetV2  # noqa: F401
from .warpnets import MiniDSNetDivide, SegDSNet  # noqa: F401


def get_network(cfg: PMTConfig, device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> torch.nn.Module:
    """Build the configured model in eval mode on ``device`` (the card by
    default; raises without one unless ``device="cpu"``), with random weights
    drawn from ``torch.Generator().manual_seed(seed)`` by the JAX package's
    initialisers. The same seed gives the same weights on every device."""
    device = resolve_device(device)
    if cfg.model.net not in MODELS:
        raise ValueError(f"unknown net {cfg.model.net!r}: one of {sorted(MODELS.keys())}")
    with torch.device("meta"):
        model = MODELS.get(cfg.model.net)(cfg.model, labels=cfg.data.n_labels)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
