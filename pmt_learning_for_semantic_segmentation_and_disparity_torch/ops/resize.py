"""Resize and pooling with the JAX package's ``ops/resize.py`` semantics.

These work on NCHW tensors (any memory format), the layout of the port's
modules; their JAX counterparts take NHWC.

* ``resize_nearest``  -- torch's floor rule, src = floor(dst * in/out)
* ``resize_bilinear`` -- half-pixel centres (align_corners=False), no
  antialiasing when downscaling
* ``avg_pool``        -- VALID windows, floor division of the spatial dims
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return resize_nearest(x, (h * factor, w * factor))


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, stride)
