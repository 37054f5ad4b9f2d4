"""The JAX package's reading of the overfit tool on the CPU, every ``--every``
epochs: the counterpart of the port's ``tools/overfit_curve.py --cpu``, so
that both packages' curves are read by committed code.

The configuration is the JAX tool's own: the root ``tools/overfit_smoke.py``
runs its ``main()`` once with ``training.Session`` replaced by a stub that
keeps the config (and its fixture), then this script sets the init seed, the
epochs, ``eval_every`` and, for ``flagship``, the flagship's model and losses
(the port's ``tools/overfit_smoke.FLAGSHIP``), and runs the JAX ``Session``.
Prints one JSON line a run, in the port's curve format: {package, config,
seed, rows: [{epoch, miou2, loss (the eval's), train_loss (the epoch's last
step)}]}.

    JAX_PLATFORMS=cpu python tests/jax_overfit_curve.py --configs fp32 --seeds 0 1 2 \\
        --epochs 160 --every 20
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

from pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.overfit_smoke import (  # noqa: E402
    FLAGSHIP,
    FLAGSHIP_LOSSES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import training  # noqa: E402

CONFIGS = {"fp32": (False, False), "bf16": (True, False), "flagship": (False, True)}  # (bf16, flagship)


def jax_tool_config(root: str, bf16: bool):
    """The root tool's configuration, its fixture written under ``root``."""
    spec = importlib.util.spec_from_file_location("jax_overfit_smoke", ROOT / "tools" / "overfit_smoke.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    seen = {}

    class Stub:
        def __init__(self, cfg, *args, **kwargs):
            seen["cfg"] = cfg

        def fit(self, log=print):
            return [{"miou2": 0.0, "loss": 0.0}]

    session, mkdtemp, update = training.Session, tempfile.mkdtemp, jax.config.update
    training.Session, tempfile.mkdtemp = Stub, lambda *a, **k: root
    jax.config.update = lambda *a, **k: None  # the tool's compile-cache directory is not this checkout's
    try:
        os.environ["OVERFIT_BF16"] = "1" if bf16 else "0"
        tool.main()
    finally:
        training.Session, tempfile.mkdtemp, jax.config.update = session, mkdtemp, update
    return seen["cfg"]


def curve(cfg, every: int) -> list:
    """Train ``cfg`` with an eval every ``every`` epochs; one row an eval."""
    cfg.run.eval_every = every
    session = training.Session(cfg)
    train_losses = []
    train_epoch = session.train_epoch

    def train_epoch_and_read(*args, **kwargs):
        out = train_epoch(*args, **kwargs)
        train_losses.append(float(out["loss"]))
        return out

    session.train_epoch = train_epoch_and_read
    history = session.fit(log=lambda *a, **k: None)
    return [{"epoch": (i + 1) * every, "miou2": float(ev["miou2"]), "loss": float(ev["loss"]),
             "train_loss": train_losses[(i + 1) * every - 1]} for i, ev in enumerate(history)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--configs", nargs="+", choices=sorted(CONFIGS), default=list(CONFIGS))
    args = ap.parse_args(argv)
    # one compile for all runs: a cache inside the checkout (git-ignored)
    jax.config.update("jax_compilation_cache_dir", str(ROOT / ".jax_cache_cpu"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    for name in args.configs:
        bf16, flagship = CONFIGS[name]
        for seed in args.seeds:
            root = tempfile.mkdtemp(prefix="jax_overfit_curve_")
            try:
                cfg = jax_tool_config(root, bf16)
                cfg.run.seed, cfg.run.epochs = seed, args.epochs
                if flagship:
                    for k, v in FLAGSHIP.items():
                        setattr(cfg.model, k, v)
                    cfg.loss.losses = FLAGSHIP_LOSSES
                rows = curve(cfg, args.every)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            print(json.dumps({"package": "jax", "config": name, "seed": seed, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
