"""Disparity loss of the JAX package's ``losses/disp.py``: masked L1."""
from __future__ import annotations

from typing import Optional

import torch


def masked_l1(disp_pred: torch.Tensor, disp_gt: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1Loss()(pred*zeros, gt*zeros) with zeros = 1 (roses/garden) or
    (gt > 0) (kitti/cityscapes), multiLosses.py:134-141."""
    if mask is None:
        return (disp_pred - disp_gt).abs().mean()
    m = mask.to(disp_pred.dtype)
    return (disp_pred * m - disp_gt * m).abs().mean()
