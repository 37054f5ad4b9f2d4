"""Disparity losses of the JAX package's ``losses/disp.py``: masked L1, the
photo-consistency of the warp nets and the edge-aware smoothness term.
NHWC."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.edges import box_count, gaussian_smooth


def masked_l1(disp_pred: torch.Tensor, disp_gt: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1Loss()(pred*zeros, gt*zeros) with zeros = 1 (roses/garden) or
    (gt > 0) (kitti/cityscapes), multiLosses.py:134-141."""
    if mask is None:
        return (disp_pred - disp_gt).abs().mean()
    m = mask.to(disp_pred.dtype)
    return (disp_pred * m - disp_gt * m).abs().mean()


def photo_consistency(warped_right: torch.Tensor, left: torch.Tensor) -> torch.Tensor:
    """MSELoss()(warped_right, left) (torch_implementation.py:314-317)."""
    return ((warped_right - left) ** 2).mean()


def _grad_with_trailing_pad(img: torch.Tensor, axis: int) -> torch.Tensor:
    """utilTorchLoss.get_gradient: |x[i] - x[i+1]| along ``axis`` of NHWC
    (1: down, 2: right), zero-padded at the trailing edge."""
    if axis == 1:
        return F.pad((img[:, :-1] - img[:, 1:]).abs(), (0, 0, 0, 0, 0, 1))
    return F.pad((img[:, :, :-1] - img[:, :, 1:]).abs(), (0, 0, 0, 1))


def smoothing_gradients(left: torch.Tensor, disp: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """The luminance-gated disparity-gradient penalty of utilTorchLoss.py:
    41-101: left (B,H,W,3), disp (B,H,W,1), seg (B,H,W,C) one-hot; max_disp
    128, a 7x7 sigma-2 gaussian on the luminance, a 3x3 intra-segment mask,
    scale 0.7."""
    lum = (0.2126 * left[..., 0] + 0.7152 * left[..., 1] + 0.0722 * left[..., 2])[..., None]
    lum = gaussian_smooth(lum, size=7, sigma=2.0)
    mask = (box_count(seg, 3, padding="SAME_ZERO") == 9.0).to(disp.dtype)
    d = disp / 128.0
    reg_down = (_grad_with_trailing_pad(d, 1) * seg * mask
                * torch.exp(1.0 - _grad_with_trailing_pad(lum, 1) * seg))
    reg_right = (_grad_with_trailing_pad(d, 2) * seg * mask
                 * torch.exp(1.0 - _grad_with_trailing_pad(lum, 2) * seg))
    return (reg_down.sum(-1) + reg_right.sum(-1)).mean() * 0.7
