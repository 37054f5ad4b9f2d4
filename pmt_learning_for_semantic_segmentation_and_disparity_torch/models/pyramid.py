"""The pyramid trunks -- backbone + PSM-style average-pool enrichment (NCHW).

Counterpart of the JAX package's ``models/pyramid.py``. Branch k of tap t
average-pools with kernel = stride = POOL_VALS[t + k] (clamped to the map
size), applies convbn(32, 3x3) + ReLU and resizes bilinearly back; an
enriched map concatenates the tap with its branches.

* ``PiramidNet2`` (the flagship's):

      b0 = cat(tap0, 5 branches)  -> C0 + 160 channels (at /2)
      b1 = cat(tap1, 4 branches)  -> C1 + 128          (at /4)
      b2 = cat(tap2, 3 branches)  -> C2 +  96          (at /8)

  returns (tap0..tap4, b2, b1, b0) in the reference's order.
* ``PiramidNetV1`` (the original piramidNet of sdnet, sdnetv2 and
  sdnet_mini, dsnet_t2.py:324-397): densenet121 only, no enriched tap 1;
  returns (tap0..tap4, b2, b0). Its tap-2 branches are named ``branch1_k``
  as in the reference, so the weights cross by name.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..core.registry import BACKBONES
from ..ops.resize import avg_pool, resize_bilinear
from .blocks import ConvBN

POOL_VALS = (128, 64, 32, 16, 8)


class _Pyramid(nn.Module):
    """Backbone + the enriched taps named by ``ENRICH``: (tap index, branch
    name prefix, number of branches), returned after the taps in reverse."""

    ENRICH: Tuple[Tuple[int, str, int], ...] = ()

    def __init__(self, backbone: str):
        super().__init__()
        self.backbone = BACKBONES.get(backbone)()
        taps = self.backbone.tap_channels
        for t, prefix, n in self.ENRICH:
            for k in range(n):
                self.add_module(f"{prefix}_{k}", ConvBN(taps[t], 32, 3, relu=True))
        self.out_channels = tuple(taps) + tuple(
            taps[t] + 32 * n for t, _, n in reversed(self.ENRICH))

    def _branch(self, inp, name: str, pool: int):
        h, w = inp.shape[-2:]
        # clamp: identical at reference resolutions, keeps small shapes defined
        pool = min(pool, h, w)
        y = getattr(self, name)(avg_pool(inp, pool, pool))
        return resize_bilinear(y, (h, w))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = self.backbone(x)
        enriched = [torch.cat([taps[t]] + [self._branch(taps[t], f"{prefix}_{k}", POOL_VALS[t + k])
                                           for k in range(n)], dim=1)
                    for t, prefix, n in self.ENRICH]
        return (*taps, *reversed(enriched))


class PiramidNet2(_Pyramid):
    ENRICH = ((0, "branch0", 5), (1, "branch1", 4), (2, "branch2", 3))

    def __init__(self, backbone: str = "densenet"):
        super().__init__(backbone)


class PiramidNetV1(_Pyramid):
    ENRICH = ((0, "branch0", 5), (2, "branch1", 3))

    def __init__(self):
        super().__init__("densenet")
