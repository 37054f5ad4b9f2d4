"""The GSCNN-style dual-task regularizer of the JAX package's
``losses/edge.py`` (utilTorchGate.py:256-306): the boundary map of a
gumbel-softmax sample of the logits against the ground truth's.

The uniform sample is drawn from a ``torch.Generator`` (the default one when
none is given) on the logits' device, or passed in as ``uniform`` (so a test
can feed the sample ``jax.random.uniform(key, shape)`` draws).
``balanced_edge_bce`` (the edge nets' loss) is ROADMAP.md queue 1, item 12.7.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.edges import compute_grad_mag


def _gumbel_softmax_sample(logits: torch.Tensor, uniform: torch.Tensor, tau: float = 0.5,
                           eps: float = 1e-10) -> torch.Tensor:
    g = -torch.log(eps - torch.log(uniform + eps))
    return ((logits + g) / tau).softmax(-1)


def dual_task_loss(logits: torch.Tensor, gt_full: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """utilTorchGate.DualTaskLoss.forward, NHWC. ``gt_full`` is one-hot with
    the ignore mask in its LAST channel (utilTorchGate.py:274), the
    cityscapes/kitti layout: C_fg + 1 channels for C_fg logits. Ground truth
    without that channel (roses, garden) raises, where the JAX package's
    loss fails on mismatched shapes."""
    if gt_full.shape[-1] != logits.shape[-1] + 1:
        raise ValueError(f"dual_edge_reg takes ground truth with a trailing ignore channel "
                         f"({logits.shape[-1] + 1} channels for {logits.shape[-1]} logits, the "
                         f"cityscapes/kitti layout), got {gt_full.shape[-1]}")
    th, eps = 0.015, 1e-10
    ignore = gt_full[..., -1:] == 1
    keep = (~ignore).to(logits.dtype)
    logits_masked = torch.where(ignore, torch.zeros_like(logits), logits)
    gt_sem = gt_full[..., :gt_full.shape[-1] - 1]
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device,
                             dtype=logits.dtype)
    g = compute_grad_mag(_gumbel_softmax_sample(logits_masked, uniform)) * keep
    g_hat = compute_grad_mag(gt_sem)
    n = logits.shape[0]
    gf, gh = g.reshape(n, -1), g_hat.reshape(n, -1)
    l1 = (gf - gh).abs()
    m_g = (gf >= th).to(logits.dtype)
    m_gh = (gh >= th).to(logits.dtype)
    loss_g = (l1 * m_g).sum() / (m_g.sum() + eps)
    loss_gh = (l1 * m_gh).sum() / (m_gh.sum() + eps)
    return 0.5 * loss_g + 0.5 * loss_gh
