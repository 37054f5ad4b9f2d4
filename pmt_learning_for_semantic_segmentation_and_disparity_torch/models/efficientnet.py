"""EfficientNet-b2..b5 feature extractor with the 5 reduction endpoints, NCHW.

Counterpart of the JAX package's ``models/efficientnet.py`` (the reference
takes efficientnet_pytorch's ``extract_endpoints``, models/dsnet_t2.py:
2025-2031): reduction k is the activation just before each resolution drop,
reduction 5 the 1x1 head conv's output at /32. b2 gives (16, 24, 48, 120,
1408) channels.

MBConv: expand 1x1 -> depthwise kxk with flax's SAME padding (asymmetric at
stride 2 on an even input, ``blocks.SameConv2d``) -> squeeze-excite over
``max(1, cin // 4)`` channels of the block's INPUT with biased 1x1 convs ->
project 1x1 -> the residual where the stride is 1 and cin == cout. Swish
activations; BatchNorm eps 1e-3 and flax momentum 0.99.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn

from ..core.registry import BACKBONES
from .blocks import SameConv2d, batch_norm, conv2d

# (expand, channels, layers, stride, kernel): the B0 stage table
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# (width, depth) multipliers
SCALES = {
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
}
BN_EPS, BN_MOMENTUM = 1e-3, 0.99


def round_filters(f: int, width: float, divisor: int = 8) -> int:
    f *= width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _bn(c: int):
    return batch_norm(c, BN_EPS, BN_MOMENTUM)


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, expand: int, kernel: int, stride: int):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand = conv2d(cin, mid, 1)
            self.expand_bn = _bn(mid)
        self.has_expand = expand != 1
        self.dw = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.dw_bn = _bn(mid)
        se = max(1, cin // 4)
        # flax nn.Conv's defaults: a bias, lecun normal (init_parameters)
        self.se_reduce = nn.Conv2d(mid, se, 1)
        self.se_expand = nn.Conv2d(se, mid, 1)
        self.project = conv2d(mid, cout, 1)
        self.project_bn = _bn(cout)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = swish(self.expand_bn(self.expand(x))) if self.has_expand else x
        y = swish(self.dw_bn(self.dw(y)))
        s = swish(self.se_reduce(y.mean(dim=(2, 3), keepdim=True)))
        y = y * torch.sigmoid(self.se_expand(s))
        y = self.project_bn(self.project(y))
        return x + y if self.residual else y


class EfficientNetFeatures(nn.Module):
    """The 5 endpoints; ``tap_channels`` gives their channel counts."""

    def __init__(self, width: float = 1.0, depth: float = 1.0, in_channels: int = 3):
        super().__init__()
        stem = round_filters(32, width)
        self.stem = SameConv2d(in_channels, stem, 3, 2)
        self.stem_bn = _bn(stem)
        cin, bi, taps = stem, 0, []
        self.drops = []  # the blocks before which an endpoint is taken
        for e, c, n, s, k in B0_STAGES:
            cout = round_filters(c, width)
            for r in range(round_repeats(n, depth)):
                stride = s if r == 0 else 1
                if stride == 2:
                    self.drops.append(bi)
                    taps.append(cin)
                self.add_module(f"block{bi}", MBConv(cin, cout, e, k, stride))
                cin = cout
                bi += 1
        self.n_blocks = bi
        head = round_filters(1280, width)
        self.head = conv2d(cin, head, 1)
        self.head_bn = _bn(head)
        self.tap_channels = tuple(taps) + (head,)

    def forward(self, x) -> List[torch.Tensor]:
        x = swish(self.stem_bn(self.stem(x)))
        endpoints = []
        for bi in range(self.n_blocks):
            if bi in self.drops:
                endpoints.append(x)  # the activation before the drop
            x = getattr(self, f"block{bi}")(x)
        endpoints.append(swish(self.head_bn(self.head(x))))  # reduction 5 at /32
        return endpoints


def _register(name: str, width: float, depth: float) -> None:
    def make(in_channels: int = 3) -> EfficientNetFeatures:
        return EfficientNetFeatures(width, depth, in_channels)

    BACKBONES.register(name)(make)


for _name, (_w, _d) in SCALES.items():
    _register(_name, _w, _d)
