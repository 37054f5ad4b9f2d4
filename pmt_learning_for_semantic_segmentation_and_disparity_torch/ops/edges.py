"""Edge and window-sum ops of the JAX package's ``ops/edges.py``, on NHWC
tensors (the losses' layout).

* ``compute_grad_mag`` -- the central-difference gradient magnitude with zero
  padding, optionally divided by its global max (utilTorchGate.py, whose
  ``convTri`` returns its input);
* ``gaussian_smooth``  -- a depthwise 2-D gaussian (fspecial's), zero SAME
  padding;
* ``box_count``        -- a depthwise all-ones window sum, ``VALID`` or
  ``SAME_ZERO``;
* ``sobel_edges``      -- the binary sobel edge map of a gray image, numpy
  on the host: the ``edges`` target of every sample and the fourth input
  channel of the nets under ``-edges``.

The window sums run as sums of shifted slices in the input's dtype, not as
convolutions: on the card a convolution may run in TF32, and the area
losses compare a box count with the window's area exactly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def numerical_gradients_2d(x: torch.Tensor):
    """Central differences (v[i+1] - v[i-1]) * 0.5 with zero padding over
    NHWC; returns (gx, gy)."""
    px = F.pad(x, (0, 0, 1, 1))
    py = F.pad(x, (0, 0, 0, 0, 1, 1))
    return (px[:, :, 2:] - px[:, :, :-2]) * 0.5, (py[:, 2:] - py[:, :-2]) * 0.5


def compute_grad_mag(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """sqrt(gx^2 + gy^2 + 1e-6), optionally divided by its global max. NHWC."""
    gx, gy = numerical_gradients_2d(x)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-6)
    return mag / mag.max() if normalize else mag


def gauss2d_kernel(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """MATLAB fspecial('gaussian') (utilTorchLoss.py:8-20)."""
    m = (size - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h.astype(np.float32)


def _window_sum(x: torch.Tensor, weights, size: int, pad: int) -> torch.Tensor:
    """sum_ij weights[i][j] * x[:, y+i-pad, x+j-pad] over NHWC, zeros
    outside; ``weights`` None means all ones. Output (H+2p-size+1,
    W+2p-size+1)."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    h, w = x.shape[1] - size + 1, x.shape[2] - size + 1
    out = None
    for i in range(size):
        for j in range(size):
            t = x[:, i:i + h, j:j + w]
            if weights is not None:
                t = t * float(weights[i][j])
            out = t if out is None else out + t
    return out


def gaussian_smooth(x: torch.Tensor, size: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Depthwise gaussian blur with zero SAME padding, NHWC."""
    return _window_sum(x, gauss2d_kernel(size, sigma), size, size // 2)


def box_count(x: torch.Tensor, size: int, padding: str = "VALID") -> torch.Tensor:
    """Depthwise all-ones window sum (the area losses, the smoothness
    intra-segment mask; utilTorchLoss.py:55-57, 472-475). NHWC."""
    if padding not in ("VALID", "SAME_ZERO"):
        raise ValueError(f"padding {padding!r}: VALID or SAME_ZERO")
    return _window_sum(x, None, size, size // 2 if padding == "SAME_ZERO" else 0)


def sobel_edges(gray: np.ndarray) -> np.ndarray:
    """Host-side sobel magnitude > 0 binary edge map, matching
    skimage.filters.sobel on the instance map (utilTorchDataLoader.py:
    152-155), pure numpy; the native decoder computes the same map."""
    g = gray.astype(np.float64)
    # skimage's sobel kernels (normalized by 4); skimage/scipy 'reflect'
    # duplicates the edge sample, numpy's mode='symmetric'
    p = np.pad(g, 1, mode="symmetric")
    gx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])) / 4.0
    gy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])) / 4.0
    mag = np.sqrt(gx * gx + gy * gy) / np.sqrt(2.0)
    return (mag > 0).astype(np.float32)
