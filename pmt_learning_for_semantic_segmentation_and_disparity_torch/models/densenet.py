"""DenseNet trunk returning 5 per-stage feature taps (NCHW).

Counterpart of the JAX package's ``models/densenet.py``: the torchvision
DenseNet without its classifier, returning [conv0, trans1, trans2, trans3,
relu(norm5)] at strides /2../32. Each transition's tap is taken BEFORE its
average pool (reference densenet.py:229-232), so tap k has the pre-pool
resolution; conv0's tap is taken before norm0.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import BACKBONES
from ..ops.resize import avg_pool
from .blocks import batch_norm, conv2d


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = batch_norm(cin)
        self.conv1 = conv2d(cin, mid, 1, init="kaiming")
        self.norm2 = batch_norm(mid)
        self.conv2 = conv2d(mid, growth_rate, 3, init="kaiming")

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class _DenseBlock(nn.Sequential):
    def __init__(self, cin: int, num_layers: int, growth_rate: int):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            _DenseLayer(cin + i * growth_rate, growth_rate))


class _Transition(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = conv2d(cin, features, 1, init="kaiming")

    def forward(self, x):
        return self.conv(F.relu(self.norm(x)))


class DenseNetFeatures(nn.Module):
    """The 5 taps; ``tap_channels`` gives their channel counts."""

    def __init__(self, block_config: Tuple[int, ...] = (6, 12, 24, 16), growth_rate: int = 32,
                 num_init_features: int = 64, in_channels: int = 3):
        super().__init__()
        self.conv0 = conv2d(in_channels, num_init_features, 7, stride=2, padding=3,
                            init="kaiming")
        self.norm0 = batch_norm(num_init_features)
        taps = [num_init_features]
        n_feat = num_init_features
        self.n_blocks = len(block_config)
        for i, num_layers in enumerate(block_config):
            self.add_module(f"denseblock{i + 1}", _DenseBlock(n_feat, num_layers, growth_rate))
            n_feat += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i + 1}", _Transition(n_feat, n_feat // 2))
                n_feat //= 2
                taps.append(n_feat)
        self.norm5 = batch_norm(n_feat)
        taps.append(n_feat)
        self.tap_channels = tuple(taps)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.conv0(x)
        taps = [x]
        x = F.max_pool2d(F.relu(self.norm0(x)), 3, 2, padding=1)  # pads with -inf
        for i in range(self.n_blocks):
            x = getattr(self, f"denseblock{i + 1}")(x)
            if i != self.n_blocks - 1:
                x = getattr(self, f"transition{i + 1}")(x)
                taps.append(x)
                x = avg_pool(x, 2, 2)
        taps.append(F.relu(self.norm5(x)))
        return taps


@BACKBONES.register("densenet")
def densenet121() -> DenseNetFeatures:
    return DenseNetFeatures((6, 12, 24, 16), 32, 64)
