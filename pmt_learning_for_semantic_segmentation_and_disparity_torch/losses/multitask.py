"""Kendall-style uncertainty-weighted multitask terms, the JAX package's
``losses/multitask.py`` (util/utilTorchLoss.py:521-540): learned
log-variances scale a per-pixel L1 (disparity) and cross entropy (the seg
heads). The log-variances are parameters of the model that calls this."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .seg import pick_class


def multitask_loss(log_var_disp: torch.Tensor, log_var_seg1: torch.Tensor,
                   log_var_seg2: Optional[torch.Tensor], disp: torch.Tensor,
                   disp_gt: torch.Tensor, seg1_logits: torch.Tensor,
                   seg2_logits: Optional[torch.Tensor], seg_labels: torch.Tensor,
                   ignore_index: int = 19) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pixel (loss_disp, loss_seg1, loss_seg2), reduction='none' as in
    the reference; the caller takes their means. NHWC logits, (B,H,W) int
    labels; without a second head, loss_seg2 is a (1,) zero."""
    valid = seg_labels != ignore_index
    safe = torch.where(valid, seg_labels, torch.zeros_like(seg_labels))

    def ce(logits):
        pix = -pick_class(F.log_softmax(logits, dim=-1), safe)
        return torch.where(valid, pix, torch.zeros_like(pix))

    loss_disp = torch.exp(-log_var_disp) * (disp - disp_gt).abs() + log_var_disp
    loss_seg1 = torch.exp(-log_var_seg1) * ce(seg1_logits) + log_var_seg1
    if seg2_logits is not None and log_var_seg2 is not None:
        loss_seg2 = torch.exp(-log_var_seg2) * ce(seg2_logits) + log_var_seg2
    else:
        loss_seg2 = torch.zeros(1, dtype=disp.dtype, device=disp.device)
    return loss_disp, loss_seg1, loss_seg2
