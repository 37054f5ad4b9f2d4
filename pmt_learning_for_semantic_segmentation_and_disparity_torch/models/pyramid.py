"""PiramidNet2 -- trunk + PSM-style average-pool pyramid enrichment (NCHW).

Counterpart of the JAX package's ``models/pyramid.py``. Branch k of tap t
average-pools with kernel = stride = POOL_VALS[t + k] (clamped to the map
size), applies convbn(32, 3x3) + ReLU and resizes bilinearly back; the
enriched maps concatenate the tap with its branches:

    b0 = cat(tap0, 5 branches)  -> C0 + 160 channels (at /2)
    b1 = cat(tap1, 4 branches)  -> C1 + 128          (at /4)
    b2 = cat(tap2, 3 branches)  -> C2 +  96          (at /8)

Returns (tap0..tap4, b2, b1, b0) in the reference's order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..core.registry import BACKBONES
from ..ops.resize import avg_pool, resize_bilinear
from .blocks import ConvBN

POOL_VALS = (128, 64, 32, 16, 8)
# branches per enriched tap
_N_BRANCHES = (5, 4, 3)


class PiramidNet2(nn.Module):
    def __init__(self, backbone: str = "densenet"):
        super().__init__()
        self.backbone = BACKBONES.get(backbone)()
        taps = self.backbone.tap_channels
        for t, n in enumerate(_N_BRANCHES):
            for k in range(n):
                self.add_module(f"branch{t}_{k}", ConvBN(taps[t], 32, 3, relu=True))
        self.out_channels = tuple(taps) + tuple(
            taps[t] + 32 * _N_BRANCHES[t] for t in (2, 1, 0))

    def _branch(self, inp, t: int, k: int):
        h, w = inp.shape[-2:]
        # clamp: identical at reference resolutions, keeps small shapes defined
        pool = min(POOL_VALS[t + k], h, w)
        y = getattr(self, f"branch{t}_{k}")(avg_pool(inp, pool, pool))
        return resize_bilinear(y, (h, w))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = self.backbone(x)
        enriched = [torch.cat([taps[t]] + [self._branch(taps[t], t, k) for k in range(n)], dim=1)
                    for t, n in enumerate(_N_BRANCHES)]
        b0, b1, b2 = enriched
        return (*taps, b2, b1, b0)
