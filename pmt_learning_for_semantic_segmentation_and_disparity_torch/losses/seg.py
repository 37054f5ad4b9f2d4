"""Segmentation losses of the JAX package's ``losses/seg.py`` (the part the
main path uses). NHWC: ``log_probs`` (B,H,W,C), one-hot ``gt`` (B,H,W,C)
already stripped of the ignore channel, class ``weights`` (C,) or None.

The JAX package picks a class by a one-hot product, because a minor-axis
gather is slow on a TPU; on the card a gather is the plain way, with the same
values and gradients."""
from __future__ import annotations

from typing import Optional

import torch


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
