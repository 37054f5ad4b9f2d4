"""The edge losses of the JAX package's ``losses/edge.py``: the
class-balanced BCE of the edge nets' edge head (multiLosses.py:166-182), and
the GSCNN-style dual-task regularizer (utilTorchGate.py:256-306): the
boundary map of a gumbel-softmax sample of the logits against the ground
truth's.

The uniform sample is drawn from a ``torch.Generator`` (the default one when
none is given) on the logits' device, or passed in as ``uniform`` (so a test
can feed the sample ``jax.random.uniform(key, shape)`` draws).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.edges import compute_grad_mag


def balanced_edge_bce(edge_logits: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Class-balanced BCE-with-logits on binary sobel edge maps, mean over
    every element: pixels of 1 weighted by the share of 0s, pixels of 0 by
    the share of 1s, any other value by 0."""
    e = edges.to(edge_logits.dtype)
    pos, neg = (e == 1.0).sum(), (e == 0.0).sum()
    total = pos + neg
    w = torch.where(e == 1.0, neg / total, torch.where(e == 0.0, pos / total, 0.0))
    z = edge_logits
    bce = z.clamp_min(0.0) - z * e + torch.log1p(torch.exp(-z.abs()))
    return (w * bce).mean()


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
