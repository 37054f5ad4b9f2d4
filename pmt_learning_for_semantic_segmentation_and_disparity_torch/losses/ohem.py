"""Online hard example mining cross entropy, counterpart of the JAX
package's ``losses/ohem.py:ohem_cross_entropy`` (losses/ohm_loss.py:8-54 of
the reference): keep the pixels whose ground-truth-class probability is at
most ``thresh`` (raised to the ``min_kept``-th smallest such probability
where that is larger), and average their cross entropy. The mask carries no
gradient. The JAX package finds the order statistic with a radix descent
because a sort is slow on a TPU; ``torch.kthvalue`` returns the same value.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .seg import class_weight_map, pick_class


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.6,
                       min_kept: int = 0, ignore_index: Optional[int] = 19,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: (B,H,W,C); labels: (B,H,W) int. Mean CE over kept pixels."""
    log_probs = F.log_softmax(logits, dim=-1)
    if ignore_index is not None:
        valid = labels != ignore_index
    else:
        valid = torch.ones_like(labels, dtype=torch.bool)
    safe_labels = torch.where(valid, labels, 0).clamp(0, logits.shape[-1] - 1)
    picked_logp = pick_class(log_probs, safe_labels)
    gt_prob = picked_logp.exp()

    threshold = torch.full((), thresh, dtype=logits.dtype, device=logits.device)
    if min_kept > 0:
        flat = torch.where(valid, gt_prob.detach(), torch.inf).reshape(-1).float()
        kth = torch.kthvalue(flat, min(min_kept, flat.numel())).values.to(logits.dtype)
        threshold = torch.where(kth > thresh, kth, threshold)

    keptf = (valid & (gt_prob.detach() <= threshold)).to(logits.dtype)
    ce = -picked_logp
    if weights is not None:
        w = class_weight_map(weights, safe_labels) * keptf
        return (ce * w).sum() / w.sum().clamp_min(1e-8)
    return (ce * keptf).sum() / keptf.sum().clamp_min(1e-8)
