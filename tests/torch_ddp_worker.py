"""One rank of the port's data-parallel CPU tests (``test_torch_ddp_step.py``,
``test_torch_mesh.py``): started once per rank by ``spawn_ranks`` with a
JSON spec, it joins a gloo group on the CPU and writes what it computed to
``{out}/rank{r}.pt``. It imports the port only (no JAX), at 2 torch threads.

Tasks (``spec["task"]``):

* ``step``: ``sdnet_mini`` at ``spec["blocks"]`` depth, CE only, dropout 0,
  weights from seed 0, in float64; one train step of this rank's slice of
  the global batch with cross-replica BatchNorm (``sync``) and with
  per-replica BatchNorm (``local``), then the sharded per-row eval step
  from the seed-0 weights.
* ``hier``: the same step, BatchNorm per replica, on the flat mesh and on
  the ``spec["mesh_shape"]`` hierarchical mesh.
* ``cli``: ``cli.train.main(spec["argv"], device="cpu")`` with the eval
  bucket ``spec["bucket"]`` and an eval after every epoch; what the rank
  printed and how many checkpoints it wrote are saved too.
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.registry import BACKBONES
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet
from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import mesh as pmesh
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    CheckpointManager,
    TrainState,
    build_optimizer,
    make_eval_step,
    make_train_step,
)


def step_config():
    cfg = PMTConfig()
    cfg.model.net = "sdnet_mini"
    cfg.loss.losses = ("cross_entropy",)
    cfg.model.dropout = 0.0
    return cfg


def float64_model(cfg):
    return models.get_network(cfg, device="cpu", seed=0).double()


def rows_of(mesh, batch):
    """This rank's slice of the global batch, as float64 tensors."""
    return {k: torch.from_numpy(v).double() for k, v in pmesh.shard_batch(mesh, batch).items()}


def train_step(cfg, mesh, batch, sync):
    """One float64 step on this rank's slice: (metrics, parameters, their
    gradients, running statistics) as numpy arrays."""
    model = float64_model(cfg)
    if sync:
        models.set_batch_norm_group(model, mesh.data_group)
    state = pmesh.replicate(mesh, TrainState.create(model, build_optimizer(
        cfg.optim, cfg.model.net, len(cfg.loss.losses))))
    _, metrics = make_train_step(cfg, model, "cpu", mesh)(state, rows_of(mesh, batch))
    return ({k: v.numpy() for k, v in metrics.items()},
            {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {n: b.numpy().copy() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))})


def main(spec):
    torch.set_num_threads(2)
    pmesh.setup_distributed(device="cpu", coordinator=f"localhost:{spec['port']}",
                            num_processes=spec["world"], process_id=spec["rank"])
    blocks = tuple(spec["blocks"])
    BACKBONES._items["densenet"] = lambda in_channels=3: densenet.DenseNetFeatures(
        blocks, 32, 64, in_channels)
    out = {}
    if spec["task"] in ("step", "hier"):
        cfg = step_config()
        batch = dict(np.load(spec["batch"]))
        if spec["task"] == "step":
            mesh = pmesh.make_mesh(device="cpu")
            out["sync"] = train_step(cfg, mesh, batch, sync=True)
            out["local"] = train_step(cfg, mesh, batch, sync=False)
            eval_step = make_eval_step(cfg, float64_model(cfg), "cpu", mesh)
            out["eval"] = {k: v.numpy() for k, v in eval_step(rows_of(mesh, batch))[1].items()}
        else:
            flat = pmesh.make_mesh(device="cpu")
            hier = pmesh.make_mesh(mesh_shape=tuple(spec["mesh_shape"]), device="cpu")
            out["flat"] = train_step(cfg, flat, batch, sync=False)
            out["hier"] = train_step(cfg, hier, batch, sync=False)
            out["hier_shape"] = dict(hier.shape)
    else:
        from pmt_learning_for_semantic_segmentation_and_disparity_torch.cli import train as cli
        from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args

        def small(argv):
            cfg = config_from_args(argv)
            cfg.data.eval_shape = tuple(spec["bucket"])
            cfg.data.num_workers = 2
            cfg.run.eval_every = 1
            return cfg

        saves = []
        save = CheckpointManager.save
        CheckpointManager.save = lambda self, *a, **kw: (saves.append(a[0]), save(self, *a, **kw))
        cli.config_from_args = small
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            session = cli.main(spec["argv"], device="cpu")
        out["printed"] = printed.getvalue()
        out["saves"] = len(saves)
        out["state"] = {k: v.clone() for k, v in session.model.state_dict().items()}
        out["summary"] = session.eval_summary
        out["rows"] = session.accumulator.rows
        out["timings"] = session.timings
    torch.save(out, os.path.join(spec["out"], f"rank{spec['rank']}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
