"""Stereo patch correlation (cost volume), NHWC in / (B,H,W,ph*pw) out.

Semantics of the JAX package's ``ops/correlation.py``:

    out[b, y, x, i*pw + j] = sum_c f1[b,y,x,c] * f2[b, y+i-ph//2, x+j-pw//2, c]

with zeros outside the image, and for ``normalize=True`` a division by the
channel count.

* ``correlation_plain``  -- shift-multiply-sum in plain PyTorch, the
  counterpart of ``correlation_lax``. It runs on CPU tensors and is the
  reference the CUDA kernel is held against on the card.
* ``correlation1d_cuda`` -- the hand-written Hopper kernel for the 1-D case
  (``csrc/corr1d.cu``), counterpart of ``correlation1d_pallas``.
* ``correlation``        -- the dispatcher: CPU tensors take the plain
  version, CUDA tensors with ``ph == 1`` the kernel (it raises if the kernel
  cannot be built or launched; there is no fallback on the card).

The CUDA path is inference-only for now: its backward raises
``NotImplementedError`` until the training slice ports the backward as
kernels (ROADMAP queue 2, item 1).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _kernels

CORR2D_ROADMAP = ("the CUDA 2-D correlation (_corr2d_kernel) is not ported yet: "
                  "ROADMAP.md queue 2, item 2")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int],
                      normalize: bool = False) -> torch.Tensor:
    """Patch correlation in plain PyTorch; products in the input dtype."""
    ph, pw = patch
    rh, rw = ph // 2, pw // 2
    b, h, w, c = f1.shape
    f2p = F.pad(f2, (0, 0, rw, rw, rh, rh))
    outs = []
    for i in range(ph):
        for j in range(pw):
            outs.append((f1 * f2p[:, i:i + h, j:j + w, :]).sum(-1))
    out = torch.stack(outs, dim=-1)
    if normalize:
        out = out / c
    return out


def _launch_corr1d(f1: torch.Tensor, f2: torch.Tensor, pw: int) -> torch.Tensor:
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation1d_cuda needs both inputs on one CUDA device, "
                         f"got {f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise ValueError(f"correlation1d_cuda takes fp32 or bf16, got {f1.dtype}, {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation1d_cuda needs two equal (B,H,W,C) shapes, "
                         f"got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation1d_cuda needs contiguous NHWC inputs")
    b, h, w, c = f1.shape
    if min(b, h, w, c) == 0 or max(b, h) > 65535 or f1.numel() >= 2**31:
        raise ValueError(f"correlation1d_cuda: unsupported shape {tuple(f1.shape)}")
    lib = _kernels.load("corr1d")
    fn = lib.corr1d_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.corr1d_patch_width.restype = ctypes.c_int
    if pw != lib.corr1d_patch_width():
        raise ValueError(f"correlation1d_cuda is built for pw={lib.corr1d_patch_width()}, got {pw}")
    out = torch.empty((b, h, w, pw), dtype=f1.dtype, device=f1.device)
    vec = (c % (16 // f1.element_size()) == 0
           and f1.data_ptr() % 16 == 0 and f2.data_ptr() % 16 == 0)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, pw,
                 int(f1.dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"corr1d kernel launch failed: cudaError {err}")
    correlation1d_cuda.launches += 1
    return out


class _Corr1dCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, pw):
        return _launch_corr1d(f1, f2, pw)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the CUDA 1-D correlation has no backward yet (training slice, ROADMAP.md "
            "queue 2, item 1); run training on the CPU path or wait for that slice")


def correlation1d_cuda(f1: torch.Tensor, f2: torch.Tensor, pw: int) -> torch.Tensor:
    """1-D horizontal correlation on the card with the ``csrc/corr1d.cu``
    kernel; NHWC in, (B,H,W,pw) out. ``correlation1d_cuda.launches`` counts
    the kernel's launches."""
    return _Corr1dCuda.apply(f1, f2, pw)


correlation1d_cuda.launches = 0


def correlation(f1: torch.Tensor, f2: torch.Tensor, patch: Tuple[int, int],
                normalize: bool = False) -> torch.Tensor:
    """Dispatch by where the tensors lie: plain PyTorch on the CPU, the
    hand-written kernel on the card."""
    ph, pw = patch
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, patch, normalize=normalize)
    if ph > 1:
        raise NotImplementedError(CORR2D_ROADMAP)
    out = correlation1d_cuda(f1, f2, pw)
    if normalize:
        # a scalar scale, kept outside the kernel as in the JAX package
        out = out / f1.shape[-1]
    return out
