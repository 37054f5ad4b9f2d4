"""Training: train steps back to back, each one call into the program's
train step (``training/step.py:make_train_step``) on its ``TrainState``
(``training/state.py``, ``training/optim.py:build_optimizer``), on a batch of
the pool.

Set-up drives the program's first three steps through the window's own call
on the pool's batches 0-2 (they warm every shape), and the window goes on
from batch 3 with the same state. The check compares those three steps with
the reference's on the same batches (``check.compare_train``); ``failed`` is
1 where a number is over its limit.
"""
from __future__ import annotations

import torch

from .. import check, harness

WINDOW = torch.enable_grad
BACKWARD = True
FIRST = check.FIRST_STEPS
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_med_gap", "out_l2")
FAULTS = ("unchanged", "half_batch", "lr_scaled")


def _state(cfg, model):
    training = harness.port("training")
    tx = training.build_optimizer(cfg.optim, cfg.model.net, len(cfg.loss.losses))
    return training.TrainState.create(model, tx)


def build(cell, weights, device, argv_extra=()) -> harness.Program:
    cfg, model = harness.build_model(cell, weights, device, argv_extra)
    step = harness.port("training").make_train_step(cfg, model, device)
    return harness.Program(cfg, model, step, _state(cfg, model))


def reload(prog, cell, weights):
    prog.model.load_state_dict(weights)
    prog.state = _state(prog.cfg, prog.model)
    return prog


def warm_up(cell, prog, pool, weights):
    steps, prog.state = check.program_first_steps(prog.call, prog.state, prog.model, pool, weights)
    return steps


def dispatch(prog, batch):
    prog.state, _ = prog.call(prog.state, batch)


def keep(cell, seed):
    return ()


def keep_outputs(out):
    return out


def readings(cell, warm, kept):
    return warm


def calibration_readings(cell, prog, pool, weights, seed):
    return warm_up(cell, prog, pool, weights)


def reference(cell, weights, pool, seed, device):
    return check.reference_first_steps(cell.flag("-net"), cell.config["labels"], cell.losses(),
                                       weights, pool, device)


def compare(cell, readings, ref):
    values = check.compare_train(readings, ref)
    return values, int(any(not values[k] <= lim for k, lim in cell.limits.items()))
