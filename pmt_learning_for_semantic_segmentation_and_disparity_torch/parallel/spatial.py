"""Spatial banding for high-resolution inference: the counterpart of the JAX
package's ``parallel/spatial.py``, over the port's NHWC tensors.

The reference's honest 'sequence parallel' analogue is tiled whole-image
eval (divideNetOutput / slideWindowInfer, SURVEY.md §5). The design: cut
the image into overlapping horizontal bands and stack the bands on the
BATCH axis, so one ordinary forward runs them all (on one card here; the
JAX package shards that axis over its mesh). No halo exchange is needed,
because the overlap is materialized up front.

The halo defaults to 64 rows. It does not make the banded forward the
monolithic one: ``split_bands`` puts zero rows above and below the image,
which the monolithic forward never sees, and a network whose field spans
the image carries them to every row. On the flagship at random init, bf16
at 2x512x960 on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
phase 12, PERF.md §6), the rows beside the image's top and bottom depart
by 48-107% of max|ref| and the other rows by 9-66%, with a 64-row halo or
one as tall as the image; the banded forward itself equals each band's
own forward put in place, exactly.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def split_bands(x: torch.Tensor, n_bands: int, halo: int = 64):
    """(B,H,W,C) -> (B*n_bands, H/n + 2*halo, W, C) plus slice info: band i
    holds rows i*H/n - halo .. (i+1)*H/n + halo, zero-padded outside the
    image, and the bands are stacked band-major on the batch axis."""
    b, h, w, c = x.shape
    if h % n_bands:
        raise ValueError(f"H = {h} is not a multiple of {n_bands} bands")
    bh = h // n_bands
    bands = []
    meta = []
    for i in range(n_bands):
        top = max(0, i * bh - halo)
        bot = min(h, (i + 1) * bh + halo)
        pad_top = halo - (i * bh - top)
        pad_bot = halo - (bot - (i + 1) * bh)
        band = x[:, top:bot]
        if pad_top or pad_bot:
            band = F.pad(band, (0, 0, 0, 0, pad_top, pad_bot))
        bands.append(band)
        meta.append((i * bh, bh))
    return torch.cat(bands, dim=0), meta, (b, h, w)


def merge_bands(y: torch.Tensor, meta, full_shape, halo: int = 64) -> torch.Tensor:
    """Inverse of split_bands for per-pixel outputs with the same H: each
    band's interior rows, halo cut off, back in place."""
    b, h, w = full_shape
    out = y.new_zeros((b, h, w, y.shape[-1]))
    for i, (start, bh) in enumerate(meta):
        out[:, start:start + bh] = y[i * b:(i + 1) * b, halo:halo + bh]
    return out


def spatial_shard_infer(
    apply_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
    left: torch.Tensor,
    right: torch.Tensor,
    n_bands: int = 8,
    halo: int = 64,
) -> Dict[str, torch.Tensor]:
    """Run a stereo forward with the image cut into bands that ride the
    batch axis; ``apply_fn(left, right)`` takes NHWC batches of any size
    (e.g. a model in eval mode, or ``make_forward_fn``'s forward on a
    batch). Returns the per-pixel outputs (4-D, band height) merged back."""
    lb, meta, full = split_bands(left, n_bands, halo)
    rb, _, _ = split_bands(right, n_bands, halo)
    out = apply_fn(lb, rb)
    merged = {}
    for k, v in out.items():
        if v is None or v.dim() != 4 or v.shape[1] != lb.shape[1]:
            continue
        merged[k] = merge_bands(v, meta, full, halo)
    return merged
