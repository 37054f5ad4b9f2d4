"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: ``cuda:LOCAL_RANK`` in a rank that torchrun
    started (one process per card), else the current card. Raises if a CUDA
    device is asked for and there is none; pass ``device="cpu"`` to run on
    the CPU."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = f"cuda:{local}" if local else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device
