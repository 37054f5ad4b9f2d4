"""Segmentation losses of the JAX package's ``losses/seg.py``. NHWC:
``log_probs`` (B,H,W,C), one-hot ``gt`` (B,H,W,C) already stripped of the
ignore channel, class ``weights`` (C,) or None.

The JAX package picks a class by a one-hot product, because a minor-axis
gather is slow on a TPU; on the card a gather is the plain way, with the same
values and gradients."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.edges import box_count


def pick_class(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[..., labels]`` per pixel: (...,C), (...) int -> (...)."""
    return torch.gather(values, -1, labels.long().unsqueeze(-1)).squeeze(-1)


def class_weight_map(weights: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``weights[labels]`` per pixel."""
    return weights[labels.long()]


def categorical_cross_entropy(log_probs: torch.Tensor, gt: torch.Tensor,
                              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """utilTorchLoss.py:373-378: mean over pixels of sum_c(-gt * logp * w)."""
    t = -gt * log_probs
    if weights is not None:
        t = t * weights
    return t.sum(-1).mean()


def binary_ce(probs: torch.Tensor, gt: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """utilTorchLoss.py:381-390: per-channel BCE of sigmoid outputs, means
    summed with the class weights. The clip's upper end, 1 - 1e-12, is 1.0
    in fp32, as in the JAX package."""
    w = weights if weights is not None else torch.ones(probs.shape[-1], dtype=probs.dtype,
                                                         device=probs.device)
    p = probs.clamp(1e-12, 1.0 - 1e-12)
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    return (w * bce.mean(dim=(0, 1, 2))).sum()


def categorical_nll(log_probs: torch.Tensor, gt_full: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    ignore_index: int = 19) -> torch.Tensor:
    """utilTorchLoss.py:393-404, NLL of the argmax labels; with weights the
    weighted SUM (the reference's size_average=False), else the mean over
    the pixels that are not ``ignore_index``."""
    labels = gt_full.argmax(-1)
    valid = (labels != ignore_index).to(log_probs.dtype)
    safe = labels.clamp(0, log_probs.shape[-1] - 1)
    picked = pick_class(log_probs, safe)
    if weights is not None:
        return (-picked * class_weight_map(weights, safe) * valid).sum()
    return (-picked * valid).sum() / valid.sum().clamp(min=1.0)


def tversky_loss2(probs: torch.Tensor, gt: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """utilTorchLoss.py:407-426, soft focal Tversky (alpha 0.7, beta 1,
    gamma 1), per class over the batch."""
    tp = (gt * probs).sum(dim=(1, 2))
    fn = (gt * (1.0 - probs)).sum(dim=(1, 2))
    fp = ((1.0 - gt) * probs).sum(dim=(1, 2))
    index = tp / (tp + 1.0 * fn + (1.0 - 0.7) * fp + 1e-6)
    loss = (1.0 - index).mean(dim=0)
    if weights is not None:
        loss = loss * weights
    return loss.mean()


def _dice_terms(log_probs: torch.Tensor, gt: torch.Tensor):
    """softmax(log_probs) (the reference's softmax of a log-softmax), and the
    per-(image, class) dice ratio and threshold, shaped (B,1,1,C)."""
    y = log_probs.softmax(-1)
    num = 2.0 * (y * gt).sum(dim=(1, 2), keepdim=True)
    den = y.sum(dim=(1, 2), keepdim=True) + gt.sum(dim=(1, 2), keepdim=True) + 1.0
    thr = (gt.sum(dim=(1, 2), keepdim=True) > 1).to(y.dtype)
    return num / den, thr


def dice_loss(log_probs: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """utilTorchLoss.py:429-436."""
    ratio, thr = _dice_terms(log_probs, gt)
    return (thr - ratio).mean()


def dice_entropy(log_probs: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """utilTorchLoss.py:439-448, dice-weighted cross entropy."""
    ratio, thr = _dice_terms(log_probs, gt)
    return (-gt * log_probs * (10.0 * (thr - ratio))).sum(-1).mean()


def _area_maps(pred: torch.Tensor, gt: torch.Tensor, area: int):
    """VALID box sums of pred and gt, kept where the window lies in one
    class, divided by the window's area."""
    total = float(area * area)
    conv_gt = box_count(gt, area, "VALID")
    conv_pred = box_count(pred, area, "VALID")
    mask = (conv_gt == total).to(pred.dtype)
    return conv_pred * mask / total, conv_gt * mask / total


def area_ce_loss(log_probs: torch.Tensor, gt: torch.Tensor, area_dim: int = 5) -> torch.Tensor:
    """utilTorchLoss.py:484-505, region cross entropy over box-filtered maps."""
    conv_pred, conv_gt = _area_maps(log_probs, gt, area_dim)
    return categorical_cross_entropy(conv_pred, conv_gt)


def area_hinge_loss(log_probs: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """utilTorchLoss.py:469-481, squared region-occupancy difference over
    5x5 windows."""
    conv_pred, conv_gt = _area_maps(log_probs.softmax(-1), gt, 5)
    return ((conv_gt - conv_pred) ** 2).sum(-1).mean()
