"""Serving: a closed loop of one client, each request one call into the
program's eval forward (``training/step.py:make_forward_fn``) under
``torch.inference_mode``, on a batch of the pool.

The check, ``out_gap``: the largest max|prog - ref| / max|ref| over seg1,
disp1, seg2 and disp2 of ``samples`` requests drawn from the seed among the
window's first ``sample_within``, against the reference's eval forward on
the same batches. ``failed`` counts the sampled requests over the limit.
"""
from __future__ import annotations

import random

import torch

from .. import check, harness

WINDOW = torch.inference_mode
BACKWARD = False
FIRST = 0
WARM_UP = 2  # requests in set-up: cuDNN's first calls at the cell's shapes
NUMBERS = ("out_gap",)
FAULTS = ("half_batch", "altered")


def build(cell, weights, device, argv_extra=()) -> harness.Program:
    cfg, model = harness.build_model(cell, weights, device, argv_extra)
    return harness.Program(cfg, model, harness.port("training").make_forward_fn(cfg, model, device))


def reload(prog, cell, weights):
    prog.model.load_state_dict(weights)
    return prog


def warm_up(cell, prog, pool, weights):
    with torch.inference_mode():
        for i in range(WARM_UP):
            prog.call(pool[i])
    return None


def dispatch(prog, batch):
    return prog.call(batch)


def keep(cell, seed):
    t = cell.traffic
    return sorted(random.Random(int(seed)).sample(range(t["sample_within"]), t["samples"]))


def keep_outputs(out):
    return {k: out[k].clone() for k in check.OUTPUTS}


def readings(cell, warm, kept):
    return kept


def calibration_readings(cell, prog, pool, weights, seed):
    with torch.inference_mode():
        return {n: keep_outputs(prog.call(pool[n % len(pool)])) for n in keep(cell, seed)}


def reference(cell, weights, pool, seed, device):
    net = check.reference_net(cell.flag("-net"), cell.config["labels"], weights, device)
    by_batch, out = {}, {}
    for n in keep(cell, seed):
        i = n % len(pool)
        if i not in by_batch:
            by_batch[i] = check.reference_outputs(net, pool[i])
        out[n] = by_batch[i]
    return out


def compare(cell, readings, ref):
    """A sampled request that never came reads infinite."""
    gaps = [check.out_gap(readings[n], r) if n in readings else float("inf")
            for n, r in ref.items()]
    limit = cell.limits.get("out_gap", float("inf"))
    return {"out_gap": max(gaps)}, sum(not g <= limit for g in gaps)
