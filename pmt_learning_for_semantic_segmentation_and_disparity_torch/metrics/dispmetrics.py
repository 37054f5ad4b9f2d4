"""On-device disparity metrics (counterpart of the JAX package's
``metrics/dispmetrics.py``: >3px counts, RMSE, SqRel and their branch-masked
variants)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def disparity_error_count(pred: torch.Tensor, gt: torch.Tensor, max_disp: float):
    """Count of valid pixels (gt > 0) with |pred - gt| * max_disp > 3, and the
    valid-pixel count."""
    th = (gt > 0).float()
    e = (pred * max_disp - gt * max_disp).abs() * th
    return (e > 3.0).float().sum(), th.sum()


class DispBatchMetrics(NamedTuple):
    err_gt3px: torch.Tensor
    valid_px: torch.Tensor
    rmse: torch.Tensor
    sq_rel: torch.Tensor
    branch_rmse: torch.Tensor
    branch_sq_rel: torch.Tensor


def disp_metrics(pred: torch.Tensor, gt: torch.Tensor, seg_full: torch.Tensor,
                 max_disp: float, mask_invalid: bool = False,
                 pixel_mask: Optional[torch.Tensor] = None) -> DispBatchMetrics:
    """pred/gt: (B,H,W,1); seg_full: (B,H,W,C) one-hot (channel 1 = branch).
    ``mask_invalid`` zeroes pixels with gt <= 0 first; ``pixel_mask`` (B,H,W)
    of 1/0 turns the means into means over real pixels. As in the JAX
    package, SqRel is NaN when a counted pixel has gt == 0."""
    p = pred[..., 0]
    g = gt[..., 0]
    if mask_invalid:
        m = (g > 0).to(p.dtype)
        p = p * m
        g = g * m
    if pixel_mask is None:
        w = torch.ones_like(g)
    else:
        w = pixel_mask.to(p.dtype)
        p = p * w
        g = g * w
    nw = w.sum().clamp(min=1.0)
    err, valid = disparity_error_count(p, g, max_disp)
    diff2 = (g - p) ** 2 * w
    rmse = torch.sqrt(diff2.sum() / nw)
    ratio = torch.where(w > 0, diff2 / torch.where(g == 0, torch.nan, g),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    sq_rel = ratio.sum() / nw
    branch = (seg_full[..., 1] == 1.0).to(p.dtype) * w
    nb = branch.sum().clamp(min=1.0)
    branch_rmse = torch.sqrt((diff2 * branch).sum() / nb)
    branch_sq_rel = (ratio * branch).sum() / nb
    return DispBatchMetrics(err, valid, rmse, sq_rel, branch_rmse, branch_sq_rel)
