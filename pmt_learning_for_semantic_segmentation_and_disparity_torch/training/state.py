"""The train state, counterpart of the JAX package's ``training/state.py``:
the model (its parameters are the fp32 master weights, its buffers the
BatchNorm running statistics), the optimizer and the step count."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import Optimizer, Transform


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Transform) -> "TrainState":
        return cls(step=0, model=model, optimizer=tx.init(model.parameters()))

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients in the parameters' ``.grad``."""
        self.optimizer.step()
        self.step += 1
        return self
