"""On-device segmentation metrics (counterpart of the JAX package's
``metrics/segmetrics.py``). Inputs are NHWC-last: logits (B,H,W,C_fg), one-hot
ground truth (B,H,W,C_full)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def confusion_matrix(pred_labels: torch.Tensor, gt_labels: torch.Tensor, n_labels: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Confusion matrix [gt, pred], (n,n) float32, as a one-hot product."""
    classes = torch.arange(n_labels, device=gt_labels.device)
    gt1 = (gt_labels[..., None] == classes).float()
    pr1 = (pred_labels[..., None] == classes).float()
    if valid is not None:
        gt1 = gt1 * valid[..., None].float()
    return gt1.reshape(-1, n_labels).T @ pr1.reshape(-1, n_labels)


def pixel_accuracy_from_preds(pred_labels: torch.Tensor, gt_labels: torch.Tensor,
                              n_labels: int,
                              pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accuracy over pixels whose gt label != n_labels (the ignore channel)."""
    mask = (gt_labels != n_labels).float()
    if pixel_mask is not None:
        mask = mask * pixel_mask
    acc = (pred_labels == gt_labels).float() * mask
    return acc.sum() / mask.sum().clamp(min=1.0)


def pixel_accuracy(conf: np.ndarray) -> float:
    """Host-side, from a confusion matrix (utilTorchLoss.py:451-452)."""
    return float(np.diag(conf).sum() / conf.sum())


def pixel_accuracy_class(conf: np.ndarray) -> float:
    """utilTorchLoss.py:455-458."""
    with np.errstate(invalid="ignore", divide="ignore"):
        acc = np.diag(conf) / conf.sum(axis=1)
    return float(np.nanmean(acc))


def mean_iou(conf: np.ndarray):
    """utilTorchLoss.py:461-466; returns (mIoU, per-class IoU)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.diag(conf) / (
            conf.sum(axis=1) + conf.sum(axis=0) - np.diag(conf)
        )
    return float(np.nanmean(iou)), iou


def branch_prf1(pred_binary: torch.Tensor, gt_binary: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
    """Micro precision / recall / F1 on binary branch maps."""
    p = pred_binary.float()
    g = gt_binary.float()
    if mask is not None:
        m = mask.float()
        p = p * m
        g = g * m
    tp = (p * g).sum()
    fp = (p * (1.0 - g)).sum() if mask is None else p.sum() - tp
    fn = g.sum() - tp
    prec = tp / (tp + fp).clamp(min=1e-8)
    rec = tp / (tp + fn).clamp(min=1e-8)
    f1 = 2.0 * prec * rec / (prec + rec).clamp(min=1e-8)
    return prec, rec, f1


class SegBatchMetrics(NamedTuple):
    pixel_acc: torch.Tensor
    confusion: torch.Tensor  # (n,n)
    precision: torch.Tensor
    recall: torch.Tensor
    f1: torch.Tensor
    branch_f1: torch.Tensor


def seg_batch_metrics(logits: torch.Tensor, gt_full: torch.Tensor, n_labels: int,
                      pixel_mask: Optional[torch.Tensor] = None) -> SegBatchMetrics:
    """All per-batch seg metrics. Branch metrics follow the roses convention:
    channel 1 thresholded at logit > 0 (channel 0 for one-channel logits).
    ``pixel_mask`` (B,H,W) of 1/0 excludes padding from every metric."""
    pred = logits.argmax(-1)
    gt = gt_full.argmax(-1)
    valid = (gt != n_labels).float()
    if pixel_mask is not None:
        valid = valid * pixel_mask
    conf = confusion_matrix(pred, gt, n_labels, valid=valid)
    acc = pixel_accuracy_from_preds(pred, gt, n_labels, pixel_mask)
    ch = 1 if logits.shape[-1] > 1 else 0
    pred_branch = (logits[..., ch] > 0).float()
    gt_branch = (gt_full[..., ch] == 1.0).float()
    if pixel_mask is not None:
        pred_branch = pred_branch * pixel_mask
        gt_branch = gt_branch * pixel_mask
    prec, rec, f1 = branch_prf1(pred_branch, gt_branch)
    branch_mask = torch.maximum(gt_branch, pred_branch)
    _, _, bf1 = branch_prf1(pred_branch, gt_branch, mask=branch_mask)
    return SegBatchMetrics(acc, conf, prec, rec, f1, bf1)
