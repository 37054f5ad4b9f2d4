"""PSMNet's concat cost volume and soft-argmin regression, the JAX package's
``ops/costvolume.py`` in plain PyTorch (the JAX package computes them outside
any Pallas kernel).

Layouts: the features are NCHW (the port's modules), the volume is NCDHW
(B, 2C, D, H, W) in channels_last_3d memory, so the 3-D convolutions that
read it run channels-last, as the JAX package's NDHWC volume does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .resize import resize_bilinear


def concat_cost_volume(ref: torch.Tensor, tgt: torch.Tensor, maxdisp4: int) -> torch.Tensor:
    """ref, tgt (B, C, H, W) quarter-resolution features -> (B, 2C, D, H, W),
    D = ``maxdisp4``: plane d holds (ref, tgt shifted right by d), both zero
    in the columns x < d (stackhourglass.py:110-119)."""
    b, c, h, w = ref.shape
    r, t = ref.permute(0, 2, 3, 1), tgt.permute(0, 2, 3, 1)  # NHWC views
    vol = ref.new_zeros((b, maxdisp4, h, w, 2 * c))
    for d in range(min(maxdisp4, w)):
        vol[:, d, :, d:, :c] = r[:, :, d:]
        vol[:, d, :, d:, c:] = t[:, :, :w - d]
    return vol.permute(0, 4, 1, 2, 3)


def soft_argmin(cost: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """disparityregression (submodule.py:56-64): the softmax over D, then
    sum(p * d). cost (B, D, H, W) -> (B, H, W)."""
    p = torch.softmax(cost, dim=1)
    d = torch.arange(maxdisp, dtype=p.dtype, device=p.device)[None, :, None, None]
    return (p * d).sum(dim=1)


def upsampled_soft_argmin(cost: torch.Tensor, maxdisp: int, out_hw: Tuple[int, int], *,
                          chunk: int = 32) -> torch.Tensor:
    """The trilinear upsample to (maxdisp, H, W), the softmax over D and the
    soft-argmin, row chunk by row chunk, so that the full-resolution volume
    never exists (only (B, maxdisp, chunk, W) slices). cost (B, D4, H4, W4)
    quarter-resolution logits -> (B, H, W).

    D and W are resized once, linearly with half-pixel centres (the JAX
    package's ``jax.image.resize`` "linear"); the rows are then interpolated
    by hand with clamped indices, as the JAX package does."""
    b, d4, h4, w4 = cost.shape
    oh, ow = out_hw
    if oh % chunk:
        raise ValueError(f"the output height {oh} is not a multiple of the chunk {chunk}")
    d = torch.arange(maxdisp, dtype=torch.float32, device=cost.device)[None, :, None, None]
    # (B, H4, D4, W4): D and W as the two resized dims of an NCHW map
    cost_dw = resize_bilinear(cost.transpose(1, 2), (maxdisp, ow)).transpose(1, 2)
    scale = h4 / oh
    rows = []
    for c0 in range(0, oh, chunk):
        src = (torch.arange(c0, c0 + chunk, dtype=torch.float32, device=cost.device) + 0.5) * scale - 0.5
        lo = src.floor().clamp(0, h4 - 1).long()
        hi = (lo + 1).clamp(0, h4 - 1)
        frac = (src - lo.float()).clamp(0.0, 1.0)
        top, bot = cost_dw[:, :, lo], cost_dw[:, :, hi]
        sl = top + (bot - top) * frac[None, None, :, None]
        rows.append((torch.softmax(sl, dim=1) * d).sum(dim=1))
    return torch.cat(rows, dim=1)
