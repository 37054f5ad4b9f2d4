"""The loss stacks of the configurations (upstream ``losses/multiLosses.py``),
on NCHW outputs and NHWC ground truth (one-hot ``seg`` (B,H,W,C), ``disp``
(B,H,W,1)):

* head 1: cross entropy of log_softmax(seg1);
* head 2: the ``-loss`` list: OHEM (x1.5, ``ohm_loss``), cross entropy and
  Lovasz-softmax (x0.5 each with more than two losses), MultiTversky (x1.5,
  ``tversky_loss``, with its upstream backward that ignores the upstream
  gradient);
* disparity: the mean absolute error of disp1 (ROSeS: no mask).

``total(out, batch, losses)`` is the training loss.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F


def cross_entropy(log_probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of -sum_c gt * log p; NHWC."""
    return (-onehot * log_probs).sum(-1).mean()


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Berman et al. 2018, over the whole batch, mean over the classes
    present. probs (N, C), labels (N,)."""
    losses, present = [], []
    for c in range(probs.shape[1]):
        fg = (labels == c).to(probs.dtype)
        err = (fg - probs[:, c]).abs()
        err_sorted, order = torch.sort(err, descending=True)
        fg_sorted = fg[order]
        inter = fg_sorted.sum() - fg_sorted.cumsum(0)
        union = fg_sorted.sum() + (1.0 - fg_sorted).cumsum(0)
        jac = 1.0 - inter / union
        jac = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append(torch.dot(err_sorted, jac))
        present.append(fg.sum() > 0)
    keep = torch.stack(present).to(probs.dtype)
    return (torch.stack(losses) * keep).sum() / keep.sum().clamp_min(1.0)


class _Tversky(torch.autograd.Function):
    """Focal binary Tversky (alpha 0.7, beta 0.3) of the upstream
    ``TverskyLoss/binarytverskyloss.py``: the value from hard labels
    (argmax of [1 - p, p]), the backward its hand-written gradient in p,
    which takes no upstream gradient: with respect to [1 - p, p] it returns
    [dT/dp1, dT/dp0]."""

    @staticmethod
    def forward(ctx, pair, target):
        n = pair.shape[0]
        hard = pair.argmax(-1).to(pair.dtype).reshape(n, -1)
        t = target.to(pair.dtype).reshape(n, -1)
        tp = (hard * t).sum(1)
        fp = (hard * (1 - t)).sum(1)
        fn = ((1 - hard) * t).sum(1)
        ctx.save_for_backward(target.to(pair.dtype), tp, fp, fn)
        return (1 - tp / (tp + 0.7 * fp + 0.3 * fn + 1e-6)).mean()

    @staticmethod
    def backward(ctx, _):
        t, tp, fp, fn = ctx.saved_tensors
        s = (tp + 0.7 * fp + 0.3 * fn + 1e-6).view(-1, 1, 1)
        tp = tp.view(-1, 1, 1)
        d0 = -2.0 * (t / s - (0.7 * (1 - t) + t) * tp / (s * s))
        d1 = 0.3 * (1 - t) * tp / (s * s)
        return torch.stack([d1, d0], -1), None


def multi_tversky(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MultiTverskyLoss: the binary loss of each class, weighted 1/C. NHWC
    probs, (B,H,W) labels."""
    c = probs.shape[-1]
    return sum(_Tversky.apply(torch.stack([1 - probs[..., k], probs[..., k]], -1), labels == k) / c
               for k in range(c))


def ohem(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.6) -> torch.Tensor:
    """Cross entropy over the pixels whose true class's probability is at
    most ``thresh`` (no minimum kept); NHWC."""
    logp = F.log_softmax(logits, -1).gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    kept = (logp.detach().exp() <= thresh).to(logits.dtype)
    return (-logp * kept).sum() / kept.sum().clamp_min(1e-8)


def head2(logits: torch.Tensor, onehot: torch.Tensor, losses: Sequence[str]) -> torch.Tensor:
    labels = onehot.argmax(-1)
    w = 0.5 if len(losses) > 2 else 1.0
    loss = logits.new_zeros(())
    if "ohm_loss" in losses:
        loss = loss + 1.5 * ohem(logits, labels)
    logp = F.log_softmax(logits, -1)
    if "cross_entropy" in losses:
        loss = loss + w * cross_entropy(logp, onehot)
        if "lovasz_loss" in losses:
            loss = loss + w * lovasz_softmax(logp.exp().reshape(-1, logp.shape[-1]),
                                             labels.reshape(-1))
    if "tversky_loss" in losses:
        loss = loss + 1.5 * multi_tversky(logp.exp(), labels)
    return loss


SUPPORTED = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")


def total(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
          losses: Sequence[str]) -> torch.Tensor:
    """The training loss of a two-head net on ROSeS: head 1's cross entropy,
    head 2's stack, disp1's mean absolute error."""
    if not set(losses) <= set(SUPPORTED) or "cross_entropy" not in losses:
        raise ValueError(f"the reference's loss stacks use {SUPPORTED} with cross_entropy, "
                         f"got {list(losses)}")
    nhwc = {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
    seg = batch["seg"]
    loss = cross_entropy(F.log_softmax(nhwc["seg1"], -1), seg)
    loss = loss + head2(nhwc["seg2"], seg, losses)
    return loss + (nhwc["disp1"] - batch["disp"]).abs().mean()
