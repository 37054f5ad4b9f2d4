"""Lovász-Softmax loss and the binary Lovász hinge (Berman 2018),
counterparts of the JAX package's ``losses/lovasz.py:lovasz_softmax`` and
``lovasz_hinge`` with its static-shape rules: ignored pixels get error 0 and
foreground 0 (so they add nothing wherever they sort), absent classes are
left out of the mean. No loss name dispatches to ``lovasz_hinge``, in either
package.

The JAX package wraps its sort in a ``custom_vjp`` to make the TPU's
un-permutation cheaper; here autograd through ``torch.sort`` computes the
same gradient. Its C = 2 path sorts once: softmax rows sum to one, so both
classes' errors are |fg1 - p1|, and both foreground vectors ride on that one
sort (the JAX package packs them into a bf16 payload; here they are gathered
by the sort's permutation). As there, the C = 2 loss reads p[..., 1] only.
"""
from __future__ import annotations

from typing import Optional

import torch


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors (Alg. 1) of one
    vector: (N,) -> (N,)."""
    gts = gt_sorted.sum()
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def _lovasz_grad_batched(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors (Alg. 1), per
    row: (C, N) -> (C, N)."""
    gts = gt_sorted.sum(1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(1)
    union = gts + (1.0 - gt_sorted).cumsum(1)
    jaccard = 1.0 - intersection / union
    if gt_sorted.shape[1] > 1:
        jaccard = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
    return jaccard


def _present_mean(losses: torch.Tensor, present: torch.Tensor, classes: str) -> torch.Tensor:
    if classes == "present":
        pres = present.to(losses.dtype)
        return (losses * pres).sum() / pres.sum().clamp_min(1.0)
    return losses.mean()


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, classes: str = "present",
                   ignore: Optional[int] = None) -> torch.Tensor:
    """probas: (B,H,W,C) probabilities; labels: (B,H,W) int; per_image=False
    (as the reference always calls it, multiLosses.py:71)."""
    c = probas.shape[-1]
    p = probas.reshape(-1, c)
    lab = labels.reshape(-1)
    valid = lab != ignore if ignore is not None else torch.ones_like(lab, dtype=torch.bool)
    validf = valid.to(p.dtype)
    cls_ids = torch.arange(c, device=lab.device)
    fg_all = ((lab[None, :] == cls_ids[:, None]) & valid[None, :]).to(p.dtype)  # (C, N)

    if c == 2:
        err = (fg_all[1] - p[:, 1]).abs() * validf
        err_sorted, perm = torch.sort(err, descending=True, stable=True)
        grad = _lovasz_grad_batched(fg_all[:, perm])
        losses = (err_sorted[None, :] * grad).sum(1)
    else:
        errors = (fg_all - p.T).abs() * validf[None, :]
        err_sorted, perm = torch.sort(errors, dim=1, descending=True, stable=True)
        grad = _lovasz_grad_batched(torch.gather(fg_all, 1, perm))
        losses = (err_sorted * grad).sum(1)
    return _present_mean(losses, fg_all.sum(1) > 0, classes)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: Optional[int] = None) -> torch.Tensor:
    """Binary Lovász hinge (util/lovasz_losses.py:78-111), per_image=False:
    ``logits`` and 0/1 ``labels`` of any one shape. The hinge is
    ``torch.maximum`` against 0, which splits the gradient at a tie as
    ``jnp.maximum`` does."""
    lg = logits.reshape(-1)
    lb = labels.reshape(-1)
    valid = lb != ignore if ignore is not None else torch.ones_like(lb, dtype=torch.bool)
    validf = valid.to(lg.dtype)
    lbf = lb.to(lg.dtype)
    errors = (1.0 - lg * (2.0 * lbf - 1.0)) * validf
    err_sorted, perm = torch.sort(errors, descending=True, stable=True)
    grad = _lovasz_grad((lbf * validf)[perm])
    return torch.dot(torch.maximum(err_sorted, torch.zeros_like(err_sorted)), grad)
