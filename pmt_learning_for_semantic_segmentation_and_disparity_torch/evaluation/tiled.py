"""Tiled / sliding-window whole-image inference (the port's counterpart of
the JAX package's ``evaluation/tiled.py``).

Re-design of the reference's two alternative paths:
* divideNetOutput — 4x overlapping 256x512 sub-crops, weight sub_crop^2,
  accumulated (torch_implementation.py:69-115);
* slideWindowInfer — 512x512 windows, stride 256, softmax accumulation
  (torch_implementation.py:187-232).

The windows are gathered into one batch and run in a SINGLE batched forward
(the reference loops windows through the model one by one), so the card sees
one large batch and the correlation kernel is launched once for all of them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _window_starts(total: int, win: int, stride: int):
    starts = list(range(0, max(total - win, 0) + 1, stride))
    if not starts:
        starts = [0]
    if starts[-1] + win < total:
        starts.append(total - win)
    return starts


def tiled_inference(
    apply_fn: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
    left: torch.Tensor,
    right: torch.Tensor,
    window: Tuple[int, int] = (256, 512),
    stride: Tuple[int, int] = (128, 256),
    softmax_seg: bool = False,
) -> Dict[str, torch.Tensor]:
    """apply_fn maps NHWC (left, right) -> output dict with seg1/disp1/seg2.

    window/stride (256,512)/(128,256) reproduces divideNetOutput's
    sub_crop=0.5 overlap; (512,512)/(256,256) + softmax_seg=True reproduces
    slideWindowInfer.
    """
    b, h, w, _ = left.shape
    wh, ww = window
    sh, sw = stride
    spots = [(y, x) for y in _window_starts(h, wh, sh) for x in _window_starts(w, ww, sw)]

    # all windows in one batch: (B*nw, wh, ww, C), window-major
    big_l = torch.cat([left[:, y:y + wh, x:x + ww] for y, x in spots])
    big_r = torch.cat([right[:, y:y + wh, x:x + ww] for y, x in spots])
    out = apply_fn(big_l, big_r)

    weight = 0.25 if not softmax_seg else 1.0
    results: Dict[str, torch.Tensor] = {}
    for key in ("seg1", "seg2", "disp1"):
        if out.get(key) is None:
            continue
        tiles = out[key]
        acc = torch.zeros((b, h, w, tiles.shape[-1]), dtype=tiles.dtype, device=tiles.device)
        for i, (y, x) in enumerate(spots):
            tile = tiles[i * b:(i + 1) * b]
            if softmax_seg and key.startswith("seg"):
                tile = torch.softmax(tile, dim=-1)
            acc[:, y:y + wh, x:x + ww] += weight * tile
        results[key] = acc
    counts = torch.zeros((1, h, w, 1), device=left.device)
    for y, x in spots:
        counts[:, y:y + wh, x:x + ww] += 1.0
    results["window_counts"] = counts
    return results
