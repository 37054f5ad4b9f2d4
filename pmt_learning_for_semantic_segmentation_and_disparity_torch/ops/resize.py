"""Resize and pooling with the JAX package's ``ops/resize.py`` semantics.

These work on NCHW tensors (any memory format), the layout of the port's
modules; their JAX counterparts take NHWC.

* ``resize_nearest``  -- torch's floor rule, src = floor(dst * in/out)
* ``resize_bilinear`` -- half-pixel centres (align_corners=False), no
  antialiasing when downscaling
* ``resize_bilinear_align_corners`` -- src = dst * (in-1)/(out-1), the
  JAX package's gather-and-lerp in the input's dtype, fp32 at least
* ``avg_pool``        -- VALID windows, floor division of the spatial dims
* ``adaptive_avg_pool`` -- the global (1, 1) case only
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


def _linear_weights_ac(in_size: int, out_size: int, dtype, device):
    if out_size == 1:
        src = torch.zeros(1, dtype=dtype, device=device)
    else:
        src = torch.arange(out_size, dtype=dtype, device=device) * ((in_size - 1) / (out_size - 1))
    lo = src.floor().long().clamp(0, in_size - 1)
    hi = (lo + 1).clamp(0, in_size - 1)
    return lo, hi, src - lo.to(dtype)


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch bilinear with align_corners=True, computed as the JAX package
    computes it (rows, then columns, each ``a + (b - a) * frac``). A 1x1
    input (ASPP's pooled branch) is a broadcast."""
    size = (int(size[0]), int(size[1]))
    h, w = x.shape[-2:]
    if (h, w) == size:
        return x
    if (h, w) == (1, 1):
        return x.expand(*x.shape[:2], *size).contiguous(memory_format=torch.channels_last)
    dtype = torch.promote_types(x.dtype, torch.float32)
    rlo, rhi, rfrac = _linear_weights_ac(h, size[0], dtype, x.device)
    clo, chi, cfrac = _linear_weights_ac(w, size[1], dtype, x.device)
    xf = x.to(dtype)
    top, bot = xf[:, :, rlo], xf[:, :, rhi]
    rows = top + (bot - top) * rfrac[:, None]
    left, right = rows[..., clo], rows[..., chi]
    return (left + (right - left) * cfrac).to(x.dtype)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, stride)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """nn.AdaptiveAvgPool2d; only the global (1, 1) case (ASPP's) is used."""
    if tuple(out_hw) != (1, 1):
        raise NotImplementedError("only global pooling is supported, as in the JAX package")
    return x.mean(dim=(2, 3), keepdim=True)
