"""The overfit tool's configuration (``tools/overfit_smoke.py``) read every
``--every`` epochs instead of once at the end: at each eval, the tool's
mIoU of head 2 and eval loss, and the epoch's last train-step loss; after
the last epoch, the gate's held readout (``batch_statistics_miou``).
``--fault`` plants the gate's negative control (``LabelFault``: each
training batch's labels rolled by one pair). Shows how far the tool's
single final eval is from what the weights have learned, and where the
held readout's limit lies between runs that learn and runs that cannot.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.overfit_curve \
        [--epochs 160] [--every 20] [--seeds 0 1 2] [--configs fp32 bf16 flagship] [--fault] [--cpu]

Configurations: ``fp32`` and ``bf16`` are the tool's ``sdnet_mini`` in
either precision; ``flagship`` is the flagship at
``scripts/train_flagship.sh``'s flags (``overfit_smoke.FLAGSHIP``, CE +
Lovász) on the tool's fixture, crop, batch and learning rate, in fp32. Each
run (a configuration at a seed) is a Session of its own, on the card unless
``--cpu``; prints one JSON line a run, then the device's name.
``tests/jax_overfit_curve.py`` reads the JAX package's curve in the same
format.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from ..core import PMTConfig
from ..training import Session
from .overfit_smoke import LabelFault, batch_statistics_miou, overfit_config

CONFIGS = {"fp32": (False, False), "bf16": (True, False), "flagship": (False, True)}  # (bf16, flagship)


def curve(cfg: PMTConfig, every: int, device=None, fault: bool = False) -> dict:
    """Train ``cfg`` with an eval every ``every`` epochs (``LabelFault``
    where ``fault``); returns {rows: one an eval, {epoch, miou2, loss,
    train_loss}, batch_statistics_miou2: the held readout after the last
    epoch}."""
    cfg.run.eval_every = every
    session = (LabelFault if fault else Session)(cfg, device=device)
    history = session.fit(log=lambda *a, **k: None)
    epochs = [min((i + 1) * every, cfg.run.epochs) for i in range(len(history))]
    rows = [{"epoch": e, "miou2": float(ev["miou2"]), "loss": float(ev["loss"]),
             "train_loss": float(session.train_history[e - 1]["loss"])} for e, ev in zip(epochs, history)]
    return {"rows": rows, "batch_statistics_miou2": batch_statistics_miou(session)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--configs", nargs="+", choices=sorted(CONFIGS), default=list(CONFIGS))
    ap.add_argument("--fault", action="store_true", help="plant the label fault (LabelFault)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    for name in args.configs:
        bf16, flagship = CONFIGS[name]
        for seed in args.seeds:
            root = tempfile.mkdtemp(prefix="overfit_curve_")
            try:
                run = curve(overfit_config(root, args.epochs, bf16, seed, flagship), args.every, device,
                            args.fault)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            print(json.dumps({"package": "port", "config": name, "seed": seed, "fault": args.fault, **run}),
                  flush=True)
    print(torch.cuda.get_device_name(0) if device is None else "cpu", flush=True)


if __name__ == "__main__":
    main()
