"""Loss composition with the reference dispatcher's rules, the counterpart
of the JAX package's ``losses/dispatch.py`` (multiLosses.py:8-157): the same
loss names, order and weights, quirks included:

* 0.5 on cross entropy (and the Lovász term beside it) with more than two
  losses, 1.5 on both Tversky losses and on OHEM;
* ``binary_ce`` hands the sigmoid, not the log-softmax, to every loss after
  it (and skips ``dual_edge_reg`` and OHEM);
* ``area_ce`` is added twice (areas 7 and 5) when ``cross_entropy`` is in
  the stack;
* the trailing ignore channel of cityscapes/kitti ground truth is stripped
  before the one-hot losses.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import seg as seg_losses
from .disp import masked_l1, smoothing_gradients
from .edge import dual_task_loss
from .lovasz import lovasz_softmax
from .ohem import ohem_cross_entropy
from .tversky import multi_tversky_loss

# multiLosses.py:46-57
CITYSCAPES_SEG_WEIGHTS = (
    5.90603017, 6.01238231, 5.90603017, 8.30641645, 7.77132999,
    5.89333853, 7.25674024, 6.0150282, 5.94274377, 7.26202977,
    6.12480687, 6.45807453, 8.21414722, 5.99393149, 9.55426071,
    9.760075, 10.09886577, 9.2037169, 7.2726336,
)


def seg_class_weights(dataset_name: str, n_labels: int) -> torch.Tensor:
    if dataset_name in ("cityscapes", "kitti"):
        return torch.tensor(CITYSCAPES_SEG_WEIGHTS, dtype=torch.float32)
    return torch.ones(n_labels, dtype=torch.float32)


def compose_seg_loss(loss_types: Sequence[str], dataset_name: str, n_labels: int,
                     seg_weight: bool = False):
    """Returns fn(logits, gt_full, generator=None, uniform=None) -> scalar
    loss. logits: (B,H,W,C_fg); gt_full: (B,H,W,C_full) one-hot, with the
    trailing ignore channel for cityscapes/kitti. ``dual_edge_reg`` draws its
    uniform sample from ``generator`` (the default one if None) unless
    ``uniform`` gives it."""
    lt = list(loss_types)
    ignore = None if dataset_name in ("garden", "roses") else 19
    weights = seg_class_weights(dataset_name, n_labels) if seg_weight else None
    w1 = 0.5 if len(lt) > 2 else 1.0

    def fn(logits: torch.Tensor, gt_full: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        gt = gt_full if ignore is None else gt_full[..., :gt_full.shape[-1] - 1]
        labels_full = gt_full.argmax(-1)
        w = None if weights is None else weights.to(logits.device)
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if "binary_ce" in lt:
            probs = torch.sigmoid(logits)
            loss = loss + seg_losses.binary_ce(probs, gt, w)
            log_probs = probs  # the losses after it see the sigmoid (reference quirk)
        else:
            if "dual_edge_reg" in lt:
                loss = loss + dual_task_loss(logits, gt_full, generator, uniform)
            if "ohm_loss" in lt:
                loss = loss + 1.5 * ohem_cross_entropy(logits, labels_full, ignore_index=19)
            log_probs = F.log_softmax(logits, dim=-1)
        if "cross_entropy" in lt:
            loss = loss + w1 * seg_losses.categorical_cross_entropy(log_probs, gt, w)
            if "lovasz_loss" in lt:
                loss = loss + w1 * lovasz_softmax(log_probs.softmax(-1), labels_full, ignore=ignore)
            if "area_ce" in lt:
                loss = loss + seg_losses.area_ce_loss(log_probs, gt, area_dim=7)
        elif "lovasz_loss" in lt:
            loss = loss + lovasz_softmax(log_probs.softmax(-1), labels_full, ignore=ignore)
        if "tversky_loss2" in lt:
            loss = loss + 1.5 * seg_losses.tversky_loss2(log_probs.softmax(-1), gt, w)
        if "tversky_loss" in lt:
            loss = loss + 1.5 * multi_tversky_loss(log_probs.softmax(-1), labels_full)
        if "area_ce" in lt:
            # a second area_ce (area 5) even beside the cross-entropy one
            # (multiLosses.py:75-78, 98-99)
            loss = loss + seg_losses.area_ce_loss(log_probs, gt, area_dim=5)
        if "categoricalNlll" in lt:
            loss = loss + seg_losses.categorical_nll(log_probs, gt_full, w)
        if "area_hinge" in lt:
            loss = loss + seg_losses.area_hinge_loss(log_probs, gt)
        if "dice_loss" in lt:
            loss = loss + seg_losses.dice_loss(log_probs, gt)
        elif "diceEntropy" in lt:
            loss = loss + seg_losses.dice_entropy(log_probs, gt)
        return loss

    return fn


def compose_disp_loss(loss_types: Sequence[str], dataset_name: str,
                      output_type: Optional[str] = None):
    """Returns fn(disp_gt, disp_pred, left=None, gt_seg_full=None) -> scalar
    (multiLosses.py:131-157): the masked L1 (masked by gt > 0 except for
    roses/garden; left out for the multitask output type, whose model
    carries its own L1 term), plus the edge-aware smoothness of
    ``smooth_grad``, which reads ``left`` and ``gt_seg_full``."""
    smooth = "smooth_grad" in loss_types
    is_multitask = output_type == "multitask"
    use_mask = dataset_name not in ("garden", "roses")

    def fn(disp_gt: torch.Tensor, disp_pred: torch.Tensor, left: Optional[torch.Tensor] = None,
           gt_seg_full: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = torch.zeros((), dtype=torch.float32, device=disp_pred.device)
        if not is_multitask:
            loss = loss + masked_l1(disp_pred, disp_gt, (disp_gt > 0) if use_mask else None)
        if smooth:
            if left is None or gt_seg_full is None:
                raise ValueError("smooth_grad needs the left image and the seg ground truth")
            loss = loss + smoothing_gradients(left, disp_pred, gt_seg_full)
        return loss

    return fn
