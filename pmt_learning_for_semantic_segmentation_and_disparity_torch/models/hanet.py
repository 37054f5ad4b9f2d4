"""HANet height-driven attention, NCHW. Counterpart of the JAX package's
``models/hanet.py`` (reference models_hanet/HANet.py:9-128 and
PosEmbedding.py:49-120).

Row-pools the low-level map to a column of 128 / pos_rfactor rows, runs a
1-3 layer 1-D conv stack with an additive row-position encoding (a frozen
sinusoid table, ``is_encoding=1``, or a learned embedding, 0), and
multiplies the sigmoid height attention onto the seg logits.

* ``pos`` is the training script's coordinate grids (``build_pos_grid``);
  the row indices are resized to the pooled length with the JAX package's
  nearest rule, ``jax.image.resize``'s half-pixel centres: src =
  floor((dst + 0.5) * in / out), not torch's floor(dst * in / out).
* ``pos_noise`` jitters the row indices in train mode only, from the
  default generator (the dropout stream).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import batch_norm


def sinusoid_table(n_position: int, dim: int) -> np.ndarray:
    """The transformer sinusoid table, plus 1 (PosEmbedding.py:55)."""
    def angle(pos, i):
        return pos / np.power(10000, 2 * (i // 2) / dim)

    tab = np.array([[angle(p, i) for i in range(dim)] for p in range(n_position)],
                   dtype=np.float32)
    tab[:, 0::2] = np.sin(tab[:, 0::2])
    if dim > 1:
        tab[:, 1::2] = np.cos(tab[:, 1::2])
    return tab + 1.0


def build_pos_grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training script's row/column grids (torch_implementation.py:
    138-144): the fixed 1024x2048 grid divided by 8 and 16, whatever the
    input size, as broadcastable (1, 1024, 1) and (1, 1, 2048) int tensors
    (only column 0 of the rows is read)."""
    del h, w  # the reference ignores the input resolution here
    pos_h = (torch.arange(1024, dtype=torch.int32, device=device) // 8)[None, :, None]
    pos_w = (torch.arange(2048, dtype=torch.int32, device=device) // 16)[None, None, :]
    return pos_h, pos_w


def adaptive_pool_rows(x: torch.Tensor, out_len: int, mode: str = "max") -> torch.Tensor:
    """AdaptiveMax/AvgPool2d((out_len, 1)) of NCHW -> (B, C, out_len): W
    pooled whole, then rows [floor(i*H/L), ceil((i+1)*H/L)) (one row at
    least), the rule of the JAX package's loop at any H."""
    if mode == "max":
        return F.adaptive_max_pool1d(x.amax(dim=3), out_len)
    return F.adaptive_avg_pool1d(x.mean(dim=3), out_len)


def _interp1d_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) of (B, C, L)."""
    return F.interpolate(x, size=out_len, mode="linear", align_corners=False)


def _resize_nearest_half_pixel(idx: torch.Tensor, out_len: int) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of (B, L) along L."""
    n = idx.shape[1]
    src = ((torch.arange(out_len, device=idx.device, dtype=torch.float64) + 0.5)
           * (n / out_len)).floor().long().clamp(0, n - 1)
    return idx[:, src]


class HANetConv(nn.Module):
    """HANet_Conv as minidsnetExt builds it (the reference defaults): kernel
    3, r_factor 64, 3 layers, max pooling, pos_rfactor 2, pos_injection 2.
    Returns (gated out, attention (B, out_channels, H))."""

    POS_RFACTOR = 2
    POOL_LEN = 128 // POS_RFACTOR

    def __init__(self, in_channels: int, out_channels: int, dropout_prob: float = 0.0,
                 is_encoding: int = 1, pos_noise: float = 0.0):
        super().__init__()
        mid1 = math.ceil(in_channels / 64)
        self.dropout_prob, self.is_encoding, self.pos_noise = dropout_prob, is_encoding, pos_noise
        self.att1_conv = _conv1d(in_channels, mid1, 1, bias=False)
        self.att1_bn = batch_norm(mid1)
        if is_encoding:
            # a constant, not a buffer: the model is built on the meta device
            self.table = sinusoid_table(self.POOL_LEN + 1, mid1)
        else:
            self.pos_emb1d_2nd = nn.Embedding(self.POOL_LEN + 1, mid1)
        self.att2_conv = _conv1d(mid1, 2 * mid1, 3)
        self.att2_bn = batch_norm(2 * mid1)
        self.att3_conv = _conv1d(2 * mid1, out_channels, 3)

    def forward(self, x: torch.Tensor, out: torch.Tensor, pos=None):
        x1d = adaptive_pool_rows(x, self.POOL_LEN, "max")
        if self.dropout_prob > 0:
            x1d = F.dropout(x1d, self.dropout_prob, training=self.training)
        x1d = F.relu(self.att1_bn(self.att1_conv(x1d)))
        if pos is not None:
            ph = _resize_nearest_half_pixel((pos[0] // self.POS_RFACTOR)[:, :, 0].long(),
                                            self.POOL_LEN)
            if self.training and self.pos_noise > 0.0:
                clamp = 16 // self.POS_RFACTOR
                noise = torch.randn(ph.shape, device=ph.device) * self.pos_noise
                ph = ph + noise.floor().long().clamp(-clamp, clamp)
            ph = ph.clamp(0, self.POOL_LEN)
            if self.is_encoding:
                emb = torch.as_tensor(self.table, device=ph.device)[ph]
            else:
                emb = self.pos_emb1d_2nd(ph)
            x1d = x1d + emb.transpose(1, 2).to(x1d.dtype)
        x1d = self.att3_conv(F.relu(self.att2_bn(self.att2_conv(x1d))))
        att = _interp1d_linear(torch.sigmoid(x1d), out.shape[2])
        return out * att[..., None], att


def _conv1d(cin: int, cout: int, kernel: int, bias: bool = True) -> nn.Conv1d:
    """flax ``nn.Conv`` over (B, L, C) with SAME padding as torch's Conv1d
    over (B, C, L): lecun (fan-in, truncated normal) weights, zero bias."""
    conv = nn.Conv1d(cin, cout, kernel, padding=kernel // 2, bias=bias)
    conv.init_rule = "lecun"
    return conv
