"""The overfit tool's training run in both packages in float64, step for
step: whether the port trains as the JAX package does over the tool's 40
steps, not only over the one or two steps of ``test_torch_train_*.py``.

The port's seeded ``sdnet_mini`` (full depth unless ``--reduced``) is carried
to the JAX package (``torch_port.variables_from_port``); both take the same
batches, those of the port's loader for the tool's configuration (the JAX
loader's equal them: ``test_torch_data.py``), through their own
``make_train_step`` in float64 (the JAX package under ``jax.enable_x64``,
with its plain heads: its s2d heads take their batch statistics in fp32,
``torch_port.jax_float64_reference``). Prints one JSON line a step: both
losses and their relative difference; then the largest relative difference
of any parameter and running statistic after the last step.

    JAX_PLATFORMS=cpu python tests/overfit_float64_trajectory.py [--steps 40] [--reduced]
"""
import argparse
import contextlib
import copy
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax_overfit_curve import jax_tool_config  # noqa: E402
from torch_port import (  # noqa: E402
    flax_stats_to_port,
    flax_to_port,
    port_stats,
    reduced_depth,
    variables_from_port,
    worst_relative,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels  # noqa: E402
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data.datasets import (  # noqa: E402
    build_datasets,
    normalization_for,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data.pipeline import DataLoader  # noqa: E402
from pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.overfit_smoke import (  # noqa: E402
    overfit_config,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (  # noqa: E402
    TrainState,
    build_optimizer,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels  # noqa: E402
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import training as jtraining  # noqa: E402

KEYS = ("left", "right", "seg", "disp")


def tool_batches(cfg, steps: int) -> list:
    """The port's training batches of the tool's configuration, one an epoch."""
    norm = normalization_for(cfg.model.backbone, cfg.model.net)
    trainset, _ = build_datasets(cfg.data, cfg.model.output_activation, cfg.model.max_disp, norm,
                                 train=cfg.run.train)
    loader = DataLoader(trainset, cfg.run.batch, shuffle=True, num_workers=0, seed=cfg.run.seed)
    out = []
    for epoch in range(steps):
        loader.set_epoch(epoch)
        out += [{k: np.asarray(b[k], np.float64) for k in KEYS} for b in loader]
    return out[:steps]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reduced", action="store_true", help="the trunk at torch_port.reduced_depth()")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    root = tempfile.mkdtemp(prefix="overfit_float64_")
    try:
        cfg = overfit_config(root, args.steps)
        jcfg = jax_tool_config(tempfile.mkdtemp(dir=root), False)
        jcfg.model.s2d_heads = False
        batches = tool_batches(cfg, args.steps)
        with reduced_depth() if args.reduced else contextlib.nullcontext():
            port = tmodels.get_network(cfg, device="cpu", seed=cfg.run.seed)
            model = jmodels.get_network(jcfg)
            key = jax.random.PRNGKey(0)
            first = {k: v.astype(np.float32) for k, v in batches[0].items()}
            variables = variables_from_port(
                port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
                key, first["left"], first["right"])
            port = copy.deepcopy(port).double()
            state = TrainState.create(port, build_optimizer(cfg.optim, cfg.model.net, len(cfg.loss.losses)))
            step = make_train_step(cfg, port, device="cpu")
            with jax.enable_x64(True):
                f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
                tx = jtraining.build_optimizer(jcfg.optim, jcfg.model.net, len(jcfg.loss.losses), 1)
                jstate = jax.tree_util.tree_map(jnp.asarray, jtraining.TrainState.create(
                    model.apply, f64(variables["params"]), f64(variables["batch_stats"]), tx))
                jstep = jtraining.make_train_step(jcfg, model, mesh=None)
                for i, batch in enumerate(batches):
                    jstate, jm = jstep(jstate, batch, key)
                    _, pm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
                    jl, pl = float(jm["loss"]), float(pm["loss"])
                    print(json.dumps({"step": i, "jax_loss": jl, "port_loss": pl,
                                      "relative": abs(pl - jl) / abs(jl)}), flush=True)
                params = {n: p.detach().numpy() for n, p in port.named_parameters()}
                print(json.dumps({
                    "steps": len(batches), "reduced": args.reduced,
                    "params": worst_relative(params, flax_to_port(jstate.params)),
                    "running_statistics": worst_relative(port_stats(port),
                                                         flax_stats_to_port(jstate.batch_stats))}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
