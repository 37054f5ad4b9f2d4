"""Horizontal disparity warping, the JAX package's ``ops/warp.py`` on NHWC
tensors: each pixel sampled at ``x + offset``, clamped to [0, W-1] and
interpolated linearly along x (the reference's flattened-index gather,
models/torch_dsnet.py:10-86). The warp nets call it as
``apply_disparity(right, -disp)`` to warp the right view into the left.

A plain gather (``torch.gather``): the JAX package computes it outside any
Pallas kernel. Its semantics are kept exactly:

* the clamp is ``minimum(maximum(x, 0), W - 1)``, which gives half the
  gradient to a coordinate lying exactly on a bound, as ``jnp.clip`` does
  (``torch.clamp`` would give all of it);
* the right neighbour is clamped before the left weight is taken
  (``w_l = i1 - xs``), so every coordinate clamped to W - 1 samples to zero;
* coordinates are in the offset's dtype, fp32 at least.
"""
from __future__ import annotations

import torch


def apply_disparity(images: torch.Tensor, x_offset: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C); x_offset (B, H, W) or (B, H, W, 1) -> (B, H, W, C)
    in the images' dtype:

        out[b, y, x] = w_l * images[b, y, i0] + w_r * images[b, y, i1]

    with xs = clip(x + x_offset, 0, W - 1), i0 = floor(xs), i1 = min(i0 + 1,
    W - 1), w_l = i1 - xs, w_r = xs - i0."""
    b, h, w, c = images.shape
    if x_offset.dim() == 4:
        x_offset = x_offset[..., 0]
    dt = torch.promote_types(x_offset.dtype, torch.float32)
    x_base = torch.arange(w, dtype=dt, device=images.device)
    xs = x_base + x_offset.to(dt)
    xs = torch.minimum(torch.maximum(xs, xs.new_zeros(())), xs.new_full((), w - 1.0))
    x0 = torch.floor(xs)
    i0 = x0.long()
    i1 = (i0 + 1).clamp(max=w - 1)
    w_l = (i1.to(dt) - xs)[..., None]
    w_r = (xs - x0)[..., None]
    pix_l = torch.gather(images, 2, i0[..., None].expand(b, h, w, c))
    pix_r = torch.gather(images, 2, i1[..., None].expand(b, h, w, c))
    return (w_l * pix_l + w_r * pix_r).to(images.dtype)
