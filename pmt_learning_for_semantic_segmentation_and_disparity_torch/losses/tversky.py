"""Focal binary / multiclass Tversky loss with the reference's hand-written
backward, counterpart of the JAX package's ``losses/tversky.py``.

The forward counts TP/FP/FN from HARD argmax labels (a piecewise-constant
value); the backward is the reference's analytic gradient w.r.t. the soft
probabilities (TverskyLoss/binarytverskyloss.py:9-108), with its two quirks:

* it IGNORES the upstream gradient, so outer factors (the 1.5 of
  multiLosses.py:93, the 1/C class weights of multitverskyloss.py:46) change
  the value but not the gradient;
* alpha = 0.7, beta = 0.3, gamma = 1 are forced.
"""
from __future__ import annotations

import torch

_ALPHA = 0.7
_BETA = 0.3
_EPS = 1e-6


class _FocalBinaryTversky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input2, target):
        b = input2.shape[0]
        hard = torch.argmax(input2, dim=-1).float().reshape(b, -1)
        t = target.float()
        t_f = t.reshape(b, -1)
        p_g = (hard * t_f).sum(1)                # TP
        p_ng = (hard * (1.0 - t_f)).sum(1)       # FP
        np_g = ((1.0 - hard) * t_f).sum(1)       # FN
        index = p_g / (p_g + _ALPHA * p_ng + _BETA * np_g + _EPS)
        ctx.save_for_backward(t, p_g, p_ng, np_g)
        ctx.dtype = input2.dtype
        return (1.0 - index).mean()

    @staticmethod
    def backward(ctx, grad_out):
        # grad_out deliberately unused: the reference's backward drops it
        t, p_g, p_ng, np_g = ctx.saved_tensors
        s = (p_g + _ALPHA * p_ng + _BETA * np_g + _EPS)[:, None, None]
        pg = p_g[:, None, None]
        sub = (_ALPHA * (1.0 - t) + t) * pg
        dT_dp0 = -2.0 * (t / s - sub / (s * s))
        dT_dp1 = _BETA * (1.0 - t) * pg / (s * s)
        # channel 0 takes dL/dp1 and channel 1 dL/dp0, as the reference does
        return torch.stack([dT_dp1, dT_dp0], dim=-1).to(ctx.dtype), None


def focal_binary_tversky(input2: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """input2: (B,H,W,2), channel 0 = 1 - p, channel 1 = p; target (B,H,W) in
    {0, 1}. Mean over the batch of 1 - Tversky index from hard labels."""
    return _FocalBinaryTversky.apply(input2, target)


def multi_tversky_loss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """MultiTverskyLoss (multitverskyloss.py:26-50) with class weights 1/C.
    probs: (B,H,W,C) softmax; labels: (B,H,W) int."""
    c = probs.shape[-1]
    total = 0.0
    for idx in range(c):
        p = probs[..., idx]
        total = total + focal_binary_tversky(torch.stack([1.0 - p, p], dim=-1),
                                             labels == idx) * (1.0 / c)
    return total
