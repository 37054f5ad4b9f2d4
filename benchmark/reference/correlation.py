"""The stereo patch correlation in plain PyTorch, NCHW:

    out[b, i*pw + j, y, x] = sum_c a[b, c, y, x] * b[b, c, y + i - ph//2, x + j - pw//2]

with zeros outside the map (FlowNet's correlation layer, as the upstream
``spatial_correlation_sampler`` computes it with stride 1 and no dilation).
Autograd through it gives both gradients.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def correlation(a: torch.Tensor, b: torch.Tensor, patch: Tuple[int, int]) -> torch.Tensor:
    ph, pw = patch
    rh, rw = ph // 2, pw // 2
    h, w = a.shape[-2:]
    bp = F.pad(b, (rw, rw, rh, rh))
    return torch.stack([(a * bp[:, :, i:i + h, j:j + w]).sum(1)
                        for i in range(ph) for j in range(pw)], 1)
