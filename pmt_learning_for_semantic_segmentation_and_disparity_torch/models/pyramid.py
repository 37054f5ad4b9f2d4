"""The pyramid trunks -- backbone + PSM-style average-pool enrichment (NCHW).

Counterpart of the JAX package's ``models/pyramid.py``. Branch k of tap t
average-pools with kernel = stride = POOL_VALS[t + k] (clamped to the map
size), applies convbn(32, 3x3) + ReLU and resizes bilinearly back; an
enriched map concatenates the tap with its branches.

* ``PiramidNet2`` (the flagship's, over any registered trunk: each exposes
  its ``tap_channels``):

      b0 = cat(tap0, 5 branches)  -> C0 + 160 channels (at /2)
      b1 = cat(tap1, 4 branches)  -> C1 + 128          (at /4)
      b2 = cat(tap2, 3 branches)  -> C2 +  96          (at /8)

  returns (tap0..tap4, b2, b1, b0) in the reference's order.
* ``PiramidNetV1`` (the original piramidNet of sdnet, sdnetv2 and
  sdnet_mini, dsnet_t2.py:324-397): densenet121 only, no enriched tap 1;
  returns (tap0..tap4, b2, b0). Its tap-2 branches are named ``branch1_k``
  as in the reference, so the weights cross by name.

* ``PiramidNet2Warp`` (the warp nets', dsnet_t2_warp.py:339-480):
  ``PiramidNet2`` plus a fourth enriched tap over tap 3 (two branches,
  pools 16/8, + 64 channels), returned in the order (tap0..tap4, b0, b1, b2,
  b3). The reference's quirk is kept: b3's second slot resizes b2's second
  branch map, and ``branch3_1`` is computed and discarded (JAX
  ``pyramid.py:137-143``). It runs in train mode only, where its running
  statistics move as the JAX model's do; in eval mode its output is unused.

``in_channels`` is the trunk's input: 4 for ``sdnet`` with ``-edges``, whose
JAX model hands its trunk the edge channel too (``sdnet_legacy.py:36-42``).
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

    def __init__(self, backbone: str, in_channels: int = 3):
        super().__init__()
        self.backbone = BACKBONES.get(backbone)(in_channels=in_channels)
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

    def __init__(self, backbone: str = "densenet", in_channels: int = 3):
        super().__init__(backbone, in_channels)


class PiramidNetV1(_Pyramid):
    ENRICH = ((0, "branch0", 5), (2, "branch1", 3))

    def __init__(self, in_channels: int = 3):
        super().__init__("densenet", in_channels)


class PiramidNet2Warp(_Pyramid):
    ENRICH = ((0, "branch0", 5), (1, "branch1", 4), (2, "branch2", 3), (3, "branch3", 2))

    def __init__(self, backbone: str = "densenet", in_channels: int = 3):
        super().__init__(backbone, in_channels)
        self.out_channels = self.out_channels[:5] + tuple(reversed(self.out_channels[5:]))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = self.backbone(x)
        branches = {t: [self._branch(taps[t], f"{prefix}_{k}", POOL_VALS[t + k]) for k in range(n)]
                    for t, prefix, n in self.ENRICH[:3]}
        enriched = [torch.cat([taps[t]] + maps, dim=1) for t, maps in branches.items()]
        out3 = taps[3]
        b3_0 = self._branch(out3, "branch3_0", POOL_VALS[3])
        if self.training:  # computed and discarded, as in the reference
            self._branch(out3, "branch3_1", POOL_VALS[4])
        # b3's second slot: branch2_1's map resized (the reference's quirk)
        b3_1 = resize_bilinear(branches[2][1], out3.shape[-2:])
        return (*taps, *enriched, torch.cat([out3, b3_0, b3_1], dim=1))
