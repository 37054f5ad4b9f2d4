"""MobileNetV3-Large trunk with taps after blocks 1, 3, 6, 12 and 15, NCHW.

Counterpart of the JAX package's ``models/mobilenetv3.py`` (reference
models/mobilenetv3.py:168-179): taps (16@/2, 24@/4, 40@/8, 112@/16,
160@/32). ``h_sigmoid``/``h_swish`` are ``F.hardsigmoid``/``F.hardswish``
(relu6(x + 3) / 6); the squeeze-excite layer is two flax ``Dense`` layers,
here ``nn.Linear``s ``fc1``/``fc2`` (``load_jax_variables`` transposes their
kernels). BatchNorm eps 1e-5, flax momentum 0.9; the depthwise convs pad
symmetrically by (k - 1) // 2.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import BACKBONES
from .blocks import batch_norm, conv2d

# k, t, c, SE, HS, s (reference models/mobilenetv3.py:201-218)
LARGE_CFG = (
    (3, 1, 16, 0, 0, 1),
    (3, 4, 24, 0, 0, 2),
    (3, 3, 24, 0, 0, 1),
    (5, 3, 40, 1, 0, 2),
    (5, 3, 40, 1, 0, 1),
    (5, 3, 40, 1, 0, 1),
    (3, 6, 80, 0, 1, 2),
    (3, 2.5, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (3, 6, 112, 1, 1, 1),
    (5, 6, 160, 1, 1, 2),
    (5, 6, 160, 1, 1, 1),
    (5, 6, 160, 1, 1, 1),
)
TAP_BLOCKS = (1, 3, 6, 12, 15)


def _make_divisible(v, divisor: int = 8, min_value=None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SELayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 4):
        super().__init__()
        hidden = _make_divisible(channel // reduction, 8)
        self.fc1 = nn.Linear(channel, hidden)
        self.fc2 = nn.Linear(hidden, channel)

    def forward(self, x):
        y = x.mean(dim=(2, 3))  # (B, C)
        y = F.hardsigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None]


class InvertedResidual(nn.Module):
    """[pw 1x1 + BN + act] -> depthwise kxk + BN -> SE and act (in that order,
    or act then SE where ``inp == hidden_dim``) -> pw-linear 1x1 + BN, with the
    identity where the stride is 1 and ``inp == oup``."""

    def __init__(self, inp: int, hidden_dim: int, oup: int, kernel: int, stride: int,
                 use_se: bool, use_hs: bool):
        super().__init__()
        self.act = F.hardswish if use_hs else F.relu
        self.identity = stride == 1 and inp == oup
        self.expand = inp != hidden_dim
        if self.expand:
            self.pw = conv2d(inp, hidden_dim, 1)
            self.pw_bn = batch_norm(hidden_dim)
        self.dw = conv2d(hidden_dim, hidden_dim, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=hidden_dim)
        self.dw_bn = batch_norm(hidden_dim)
        self.se = SELayer(hidden_dim) if use_se else None
        self.pw_lin = conv2d(hidden_dim, oup, 1)
        self.pw_lin_bn = batch_norm(oup)

    def forward(self, x):
        y = self.act(self.pw_bn(self.pw(x))) if self.expand else x
        y = self.dw_bn(self.dw(y))
        if not self.expand:
            y = self.act(y)
            if self.se is not None:
                y = self.se(y)
        else:
            if self.se is not None:
                y = self.se(y)
            y = self.act(y)
        y = self.pw_lin_bn(self.pw_lin(y))
        return x + y if self.identity else y


class MobileNetV3LargeFeatures(nn.Module):
    """The 5 taps; ``tap_channels`` gives their channel counts."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.stem = conv2d(in_channels, 16, 3, stride=2, padding=1)
        self.stem_bn = batch_norm(16)
        inp, taps = 16, []
        for i, (k, t, c, se, hs, s) in enumerate(LARGE_CFG):
            oup = _make_divisible(c * 1.0, 8)
            hidden = _make_divisible(inp * t, 8)
            self.add_module(f"block{i + 1}", InvertedResidual(inp, hidden, oup, k, s, bool(se),
                                                              bool(hs)))
            inp = oup
            if i + 1 in TAP_BLOCKS:
                taps.append(oup)
        self.tap_channels = tuple(taps)

    def forward(self, x) -> List[torch.Tensor]:
        x = F.hardswish(self.stem_bn(self.stem(x)))
        taps = []
        for i in range(len(LARGE_CFG)):
            x = getattr(self, f"block{i + 1}")(x)
            if i + 1 in TAP_BLOCKS:
                taps.append(x)
        return taps


@BACKBONES.register("mobilenet")
def mobilenetv3_large(in_channels: int = 3) -> MobileNetV3LargeFeatures:
    return MobileNetV3LargeFeatures(in_channels)
