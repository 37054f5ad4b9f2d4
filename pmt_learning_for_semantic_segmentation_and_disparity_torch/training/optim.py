"""Optimizers and learning-rate schedules, counterpart of the JAX package's
``training/optim.py`` (torch_implementation.py:715-724 and 599-609 of the
reference):

* Adam with eps 1e-7 and the net/loss-count learning-rate rule
  (``OptimConfig.resolve_lr``), as ``optax.adam``;
* SGD with momentum 0.9 and weight decay 1e-4 added to the gradient first
  (``optax.add_decayed_weights`` then ``optax.sgd``), under the poly schedule
  lr = base * (1 - t / (horizon * steps_per_epoch));
* gradient accumulation over ``accumulate_grad`` steps, as
  ``optax.MultiSteps``: the running mean of the gradients, one update every k
  steps and none in between.

``build_optimizer`` returns a ``Transform``; ``Transform.init(params)`` makes
the stateful ``Optimizer`` that ``TrainState`` holds. Its ``step()`` reads
each parameter's ``.grad``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

import torch

from ..core.config import OptimConfig


def poly_factor(step: int, steps_per_epoch: int, epoch_horizon: int = 2400) -> float:
    """The poly schedule's factor for the update ``step`` (0 first): 1 -
    step / total, clamped at the last step as the reference does."""
    total = max(1, epoch_horizon * steps_per_epoch)
    return 1.0 - min(step, total - 1) / float(total)


class Optimizer:
    """A ``torch.optim`` optimizer (with the poly ``LambdaLR`` for SGD) behind
    gradient accumulation."""

    def __init__(self, params: List[torch.Tensor], inner: torch.optim.Optimizer,
                 schedule, every_k: int):
        self.params = params
        self.inner = inner
        self.schedule = schedule
        self.every_k = every_k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params] if every_k > 1 else None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Apply the gradients in ``.grad`` (a missing one counts as zero)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.acc is not None:
            n = self.mini_step
            for a, p in zip(self.acc, self.params):
                a.add_(p.grad - a, alpha=1.0 / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return
            for a, p in zip(self.acc, self.params):
                p.grad.copy_(a)
                a.zero_()
        self.inner.step()
        if self.schedule is not None:
            self.schedule.step()

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the inner optimizer's state (Adam's
        moments and step), the schedule's position, and the accumulation."""
        return {"inner": self.inner.state_dict(),
                "schedule": self.schedule.state_dict() if self.schedule is not None else None,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        if self.schedule is not None:
            self.schedule.load_state_dict(state["schedule"])
        self.mini_step = state["mini_step"]
        if self.acc is not None:
            for a, b in zip(self.acc, state["acc"]):
                a.copy_(b)


@dataclass
class Transform:
    cfg: OptimConfig
    net: str
    n_losses: int
    steps_per_epoch: int = 1

    def init(self, params: Iterable[torch.Tensor]) -> Optimizer:
        cfg = self.cfg
        params = list(params)
        schedule = None
        if cfg.optim_type == "sgd":
            inner = torch.optim.SGD(params, lr=cfg.poly_base_lr, momentum=cfg.sgd_momentum,
                                    weight_decay=cfg.sgd_weight_decay)
            spe, horizon = self.steps_per_epoch, cfg.poly_epoch_horizon
            schedule = torch.optim.lr_scheduler.LambdaLR(
                inner, lambda t: poly_factor(t, spe, horizon))
        else:
            inner = torch.optim.Adam(params, lr=cfg.resolve_lr(self.net, self.n_losses),
                                     eps=cfg.adam_eps)
        return Optimizer(params, inner, schedule, max(1, cfg.accumulate_grad))


def build_optimizer(cfg: OptimConfig, net: str, n_losses: int,
                    steps_per_epoch: int = 1) -> Transform:
    return Transform(cfg, net, n_losses, steps_per_epoch)
