"""Dilated ResNet-50/101 trunk (deeplab style) with 5 taps, NCHW.

Counterpart of the JAX package's ``models/resnet_deeplab.py`` (reference
models/resnet_deeplab.py:45-170). Two flavours behind one module:

* ``stem="7x7"``, ``multigrid=True`` (registered "resnet50", "resnet101"):
  output stride 16, strides (1, 2, 2, 1), dilations (1, 1, 1, 2), layer 4 the
  three multi-grid blocks at dilations (1, 2, 4) x 2 whatever ``layers[3]``
  says. Taps (64@/2, 256@/4, 512@/8, 1024@/16, 2048@/16): taps 3 and 4 share
  one resolution.
* ``stem="3x3x3"``, ``multigrid=False`` (HANet's ResNet3X3, the dlab net's
  trunk at output stride 8): three 3x3 convs (64, 64, 128), then the max
  pool; strides (1, 2, 1, 1), uniform dilations (1, 1, 2, 4).

Convolutions are bias-free with the he fan-out init; BatchNorm eps 1e-5,
flax momentum 0.9.
"""
from __future__ import annotations

from typing import List, Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..core.registry import BACKBONES
from .blocks import batch_norm, conv2d

MULTIGRID = (1, 2, 4)
_STRIDES = {16: ((1, 2, 2, 1), (1, 1, 1, 2)), 8: ((1, 2, 1, 1), (1, 1, 2, 4))}


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, each with BN, and the
    projected residual (``down_conv``/``down_bn``) where the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(cin, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, stride=stride, dilation=dilation, padding=dilation)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv2d(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        if downsample:
            self.down_conv = conv2d(cin, planes * 4, 1, stride=stride, padding=0)
            self.down_bn = batch_norm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(y + residual)


class ResNetDeeplabFeatures(nn.Module):
    """The 5 taps; ``tap_channels`` gives their channel counts."""

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 23, 3), output_stride: int = 16,
                 stem: str = "7x7", multigrid: bool = True, in_channels: int = 3):
        super().__init__()
        if output_stride not in _STRIDES:
            raise NotImplementedError(f"output stride {output_stride}: 8 or 16")
        strides, dils = _STRIDES[output_stride]
        self.stem = stem
        if stem == "3x3x3":
            self.conv1 = conv2d(in_channels, 64, 3, stride=2, padding=1)
            self.bn1 = batch_norm(64)
            self.conv2 = conv2d(64, 64, 3)
            self.bn2 = batch_norm(64)
            self.conv3 = conv2d(64, 128, 3)
            self.bn3 = batch_norm(128)
            stem_out = 128
        else:
            self.conv1 = conv2d(in_channels, 64, 7, stride=2, padding=3)
            self.bn1 = batch_norm(64)
            stem_out = 64
        # the JAX model starts its first stage from 64 planes whatever the
        # stem gives, so its first block projects the 3x3x3 stem's 128 too
        inplanes = 64
        cin = stem_out
        self.names: List[List[str]] = []
        for li, (planes, nblocks, stride, dil) in enumerate(zip((64, 128, 256, 512), layers,
                                                                strides, dils)):
            grid = MULTIGRID if li == 3 and multigrid else (1,) * nblocks
            names = []
            for bi, g in enumerate(grid):
                down = bi == 0 and (stride != 1 or inplanes != planes * 4)
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, Bottleneck(cin, planes, stride if bi == 0 else 1, g * dil,
                                                 down))
                names.append(name)
                inplanes = cin = planes * 4
            self.names.append(names)
        self.tap_channels = (stem_out, 256, 512, 1024, 2048)

    def forward(self, x) -> List:
        x = F.relu(self.bn1(self.conv1(x)))
        if self.stem == "3x3x3":
            x = F.relu(self.bn2(self.conv2(x)))
            x = F.relu(self.bn3(self.conv3(x)))
        taps = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        for names in self.names:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        return taps


@BACKBONES.register("resnet50")
def resnet50_deeplab(in_channels: int = 3) -> ResNetDeeplabFeatures:
    return ResNetDeeplabFeatures((3, 4, 6, 3), 16, in_channels=in_channels)


@BACKBONES.register("resnet101")
def resnet101_deeplab(in_channels: int = 3) -> ResNetDeeplabFeatures:
    return ResNetDeeplabFeatures((3, 4, 23, 3), 16, in_channels=in_channels)
