"""ASPP (the dsnet flavour): four dilated branches and a global-pool branch,
NCHW. Counterpart of the JAX package's ``models/aspp.py`` (reference
models/aspp.py:7-112).

The dilations are keyed by the output stride (32 -> 1, 2, 6, 12; 16 -> 1, 6,
12, 18; 8 -> 1, 12, 24, 36). The convolutions are bias-free with the
kaiming (fan-in, truncated normal) init; every BatchNorm is the port's
``blocks.BatchNorm2d``. The dropout after the projection is the module's
own (0.5 by default), not ``cfg.model.dropout``.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F
import torch

from ..ops.resize import adaptive_avg_pool, resize_bilinear_align_corners
from .blocks import batch_norm, conv2d

DILATIONS = {32: (1, 2, 6, 12), 16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}


class ASPP(nn.Module):
    def __init__(self, cin: int, output_stride: int = 32, features: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        dils = DILATIONS[output_stride]
        for i, (k, d) in enumerate(zip((1, 3, 3, 3), dils), start=1):
            self.add_module(f"aspp{i}_conv", conv2d(cin, features, k, dilation=d, init="kaiming"))
            self.add_module(f"aspp{i}_bn", batch_norm(features))
        self.gp_conv = conv2d(cin, features, 1, init="kaiming")
        self.gp_bn = batch_norm(features)
        self.proj_conv = conv2d(5 * features, features, 1, init="kaiming")
        self.proj_bn = batch_norm(features)
        self.dropout = dropout
        self.out_channels = features

    def forward(self, x):
        branches = [F.relu(getattr(self, f"aspp{i}_bn")(getattr(self, f"aspp{i}_conv")(x)))
                    for i in (1, 2, 3, 4)]
        gp = F.relu(self.gp_bn(self.gp_conv(adaptive_avg_pool(x))))
        branches.append(resize_bilinear_align_corners(gp, x.shape[-2:]))
        y = F.relu(self.proj_bn(self.proj_conv(torch.cat(branches, dim=1))))
        return F.dropout(y, self.dropout, training=self.training) if self.dropout > 0 else y
