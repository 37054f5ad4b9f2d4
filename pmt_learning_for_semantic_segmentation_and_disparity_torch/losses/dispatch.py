"""Loss composition with the reference dispatcher's weight rules, the
counterpart of the JAX package's ``losses/dispatch.py`` (multiLosses.py:
8-157): 0.5 on cross entropy (and the Lovász term beside it) with more than
two losses, 1.5 on Tversky and OHEM, and the trailing ignore channel of
cityscapes/kitti ground truth stripped before the one-hot losses.

The port has the main path's losses: cross_entropy, lovasz_loss,
tversky_loss, ohm_loss (and "None", which adds nothing); any other name
raises ``NotImplementedError`` when the loss is composed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import seg as seg_losses
from .disp import masked_l1
from .lovasz import lovasz_softmax
from .ohem import ohem_cross_entropy
from .tversky import multi_tversky_loss

PORTED_SEG_LOSSES = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss", "None")
_UNPORTED = "is not ported yet (ROADMAP.md queue 1, item 7.1)"

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
    """Returns fn(logits, gt_full) -> scalar loss. logits: (B,H,W,C_fg);
    gt_full: (B,H,W,C_full) one-hot, with the trailing ignore channel for
    cityscapes/kitti."""
    loss_types = list(loss_types)
    for name in loss_types:
        if name not in PORTED_SEG_LOSSES:
            raise NotImplementedError(f"the loss {name!r} {_UNPORTED}")
    ignore = None if dataset_name in ("garden", "roses") else 19
    weights = seg_class_weights(dataset_name, n_labels) if seg_weight else None
    w1 = 0.5 if len(loss_types) > 2 else 1.0

    def fn(logits: torch.Tensor, gt_full: torch.Tensor) -> torch.Tensor:
        gt = gt_full if ignore is None else gt_full[..., :gt_full.shape[-1] - 1]
        labels_full = gt_full.argmax(-1)
        w = None if weights is None else weights.to(logits.device)
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if "ohm_loss" in loss_types:
            loss = loss + 1.5 * ohem_cross_entropy(logits, labels_full, ignore_index=19)
        log_probs = F.log_softmax(logits, dim=-1)
        lovasz = "lovasz_loss" in loss_types
        if "cross_entropy" in loss_types:
            loss = loss + w1 * seg_losses.categorical_cross_entropy(log_probs, gt, w)
        if lovasz:
            scale = w1 if "cross_entropy" in loss_types else 1.0
            loss = loss + scale * lovasz_softmax(log_probs.softmax(-1), labels_full, ignore=ignore)
        if "tversky_loss" in loss_types:
            loss = loss + 1.5 * multi_tversky_loss(log_probs.softmax(-1), labels_full)
        return loss

    return fn


def compose_disp_loss(loss_types: Sequence[str], dataset_name: str,
                      output_type: Optional[str] = None):
    """Returns fn(disp_gt, disp_pred) -> scalar: the masked L1 of
    multiLosses.py:131-157, masked by gt > 0 except for roses/garden."""
    if "smooth_grad" in loss_types:
        raise NotImplementedError(f"the loss 'smooth_grad' {_UNPORTED}")
    if output_type == "multitask":
        raise NotImplementedError("multaskloss is not ported yet (ROADMAP.md queue 1, item 12.7)")
    use_mask = dataset_name not in ("garden", "roses")

    def fn(disp_gt: torch.Tensor, disp_pred: torch.Tensor) -> torch.Tensor:
        return masked_l1(disp_pred, disp_gt, (disp_gt > 0) if use_mask else None)

    return fn
