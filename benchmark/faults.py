"""Faults planted in the program's timed call, for the tests and the
calibration of the limits (``calibrate.py``); a run of the benchmark never
plants one. Each wraps the call: ``FAULTS[name](call, mode)``.

* ``unchanged`` (training): the step computes its loss and gradients and
  returns the state without applying them;
* ``half_batch``: the call sees the first half of the batch alone; serving
  answers the second half with the first half's outputs, training takes
  the loss's mean over the half;
* ``altered`` (serving): the first pair's disparity is answered with the
  second pair's, where the forward produces it;
* ``lr_scaled`` (training): every step applies its update at 1.2 times the
  learning rate the configuration states.

Which faults a mode can have, its module says (``modes/<mode>.py:FAULTS``).
"""
from __future__ import annotations


def unchanged(call, mode):
    if mode != "train":
        raise ValueError("unchanged is a training fault")

    def step(state, batch):
        apply = state.apply_gradients
        state.apply_gradients = lambda: state
        try:
            return call(state, batch)
        finally:
            state.apply_gradients = apply

    return step


def _half(batch):
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def half_batch(call, mode):
    import torch

    if mode == "train":
        return lambda state, batch: call(state, _half(batch))

    def forward(batch):
        out = call(_half(batch))
        return {k: torch.cat([v, v]) if isinstance(v, torch.Tensor) else v for k, v in out.items()}

    return forward


def altered(call, mode):
    if mode != "serve":
        raise ValueError("altered is a serving fault")

    def forward(batch):
        out = dict(call(batch))
        d = out["disp1"].clone()
        d[0] = d[1]
        out["disp1"] = d
        return out

    return forward


def lr_scaled(call, mode, factor=1.2):
    if mode != "train":
        raise ValueError("lr_scaled is a training fault")

    def step(state, batch):
        groups = state.optimizer.inner.param_groups
        stated = [g["lr"] for g in groups]
        for g in groups:
            g["lr"] = g["lr"] * factor
        try:
            return call(state, batch)
        finally:
            for g, lr in zip(groups, stated):
                g["lr"] = lr

    return step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "lr_scaled": lr_scaled}
