"""Test-time augmentation of the mono deeplab net, the JAX package's
``evaluation/tta.py`` (SegmentatorTTA, models_deeplab/tta.py:3-42): the
prediction averaged over a horizontal flip and, optionally, extra scales,
each with the deeplab alignment (``pred_resize`` pads by one and resizes with
align_corners=True). NHWC tensors.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_align_corners


def _resize_ac(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear_align_corners`` of an NHWC tensor."""
    return resize_bilinear_align_corners(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def hflip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(2)


def pred_resize(forward: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                size: Tuple[int, int], net_type: str = "deeplab") -> torch.Tensor:
    """The prediction of ``x`` at ``size``: "unet" resizes it there;
    "deeplab" predicts ``x`` padded by one row and column, resizes to (h + 1,
    w + 1) and crops."""
    h, w = size
    if net_type == "unet":
        pred = forward(x)
        return pred if tuple(x.shape[1:3]) == tuple(size) else _resize_ac(pred, size)
    pred = forward(F.pad(x, (0, 0, 0, 1, 0, 1)))
    return _resize_ac(pred, (h + 1, w + 1))[:, :h, :w]


def tta(forward: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
        scales: Optional[Sequence[float]] = None, net_type: str = "deeplab") -> torch.Tensor:
    """hflip (+ multi-scale) averaged prediction (tta.py:28-42)."""
    size = tuple(x.shape[1:3])
    seg_sum = pred_resize(forward, x, size, net_type)
    seg_sum = seg_sum + hflip(pred_resize(forward, hflip(x), size, net_type))
    if not scales:
        return seg_sum / 2.0
    for s in scales:
        hs, ws = max(1, int(round(x.shape[1] * s))), max(1, int(round(x.shape[2] * s)))
        scaled = _resize_ac(x, (hs, ws))
        seg_sum = seg_sum + pred_resize(forward, scaled, size, net_type)
        seg_sum = seg_sum + hflip(pred_resize(forward, hflip(scaled), size, net_type))
    return seg_sum / ((len(scales) + 1) * 2.0)
