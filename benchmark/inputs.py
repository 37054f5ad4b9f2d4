"""What the benchmark hands to both the program and the reference, made from
``--seed`` on the run's device by generators of its own, in a few large
calls:

* ``weights``: every parameter and buffer of the reference net by name, in
  sorted order; a convolution's weight normal with the He fan-in std
  sqrt(2 / (I k k)), all of them from one draw; BatchNorm scale 1, shift 0,
  running mean 0, running variance 1.
* ``pool``: the traffic's distinct batches, NHWC as the program takes them.
  Each pair draws a brightness b in ``brightness`` and a foreground share f
  in ``fg_share``: ``left`` and ``right`` are b times uniform noise in
  [0, 1); a pixel of ``seg`` (one-hot) is class 0 with probability 1 - f,
  else one of the others alike; ``disp`` is uniform in [0, ``disp_max``). So
  the pairs of a batch differ in their statistics and their losses, as a
  user's pairs do, and a batch that lost some of its pairs reads otherwise.

The same seed gives the same tensors on every call.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

WEIGHTS_STREAM, DATA_STREAM = 0, 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of ``device`` for one of the run's streams, from any
    whole-number seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 2 + stream) % 2**63)


def weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """``template``: a state_dict of the reference net (shapes and names)."""
    names = sorted(template)
    convs = [n for n in names if n.endswith("weight") and template[n].dim() == 4]
    total = sum(template[n].numel() for n in convs)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS_STREAM, device), device=device)
    out, at = {}, 0
    for n in names:
        t = template[n]
        if n in convs:
            fan_in = t[0].numel()
            out[n] = flat[at:at + t.numel()].view(t.shape).mul_(math.sqrt(2.0 / fan_in))
            at += t.numel()
        elif n.endswith(("weight", "running_var")):
            out[n] = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:  # bias, running_mean, num_batches_tracked
            out[n] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def pool(traffic: dict, labels: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The traffic's ``pool`` distinct batches of ``batch`` pairs of
    ``height`` x ``width``."""
    g = generator(seed, DATA_STREAM, device)
    p, b, h, w = traffic["pool"], traffic["batch"], traffic["height"], traffic["width"]

    def per_pair(lo_hi):
        lo, hi = lo_hi
        return (lo + (hi - lo) * torch.rand(p, b, 1, 1, generator=g, device=device))

    bright, fg = per_pair(traffic["brightness"]), per_pair(traffic["fg_share"])
    left = torch.rand(p, b, h, w, 3, generator=g, device=device).mul_(bright[..., None])
    right = torch.rand(p, b, h, w, 3, generator=g, device=device).mul_(bright[..., None])
    other = torch.randint(1, max(labels, 2), (p, b, h, w), generator=g, device=device)
    seg = torch.where(torch.rand(p, b, h, w, generator=g, device=device) < fg, other, 0)
    disp = torch.rand(p, b, h, w, 1, generator=g, device=device).mul_(traffic["disp_max"])
    onehot = torch.nn.functional.one_hot(seg, labels).float()
    return [{"left": left[i], "right": right[i], "seg": onehot[i], "disp": disp[i]}
            for i in range(p)]
