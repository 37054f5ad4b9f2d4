"""The benchmark's plain reference: the two nets of its configurations, their
correlations, the four losses and Adam, in plain PyTorch (NCHW, no kernels,
no channels_last, no batching tricks).

It imports nothing of the program under test. It follows the published
description of the nets (``models/dsnet_t2.py`` of the upstream repository:
``minidsnetExt`` :941-1299 and ``dsnet`` :119-321) and the loss dispatcher
(``losses/multiLosses.py``), with the program's parameter names so that the
benchmark's weights load into both. Run it in fp32 with TF32 off
(``fp32_exact``).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuBLAS and cuDNN inside the block; the flags as they
    were after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
