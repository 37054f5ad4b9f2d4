"""Adam (Kingma and Ba 2015) as the upstream trains with it: betas (0.9,
0.999), eps 1e-7 added to the bias-corrected root of the second moment, no
weight decay; a parameter without a gradient counts a zero gradient. The
learning rate by the upstream rule (torch_implementation.py:715-724): 5e-4
with more than two losses, else 1.5e-3."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-7


def learning_rate(losses: Sequence[str]) -> float:
    return 5e-4 if len(losses) > 2 else 1.5e-3


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g
            self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + EPS))
