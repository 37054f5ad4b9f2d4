"""The port's data-parallel train and eval steps on two gloo ranks on the
CPU (``torch_ddp_worker.py``, spawned once for the module), against the
JAX package's ``make_train_step``/``make_eval_step`` on
``make_mesh(n_devices=2)`` (conftest's emulated devices) and against the
port's own one-process step on the global batch.

``sdnet_mini`` with the trunk at ``reduced_depth()``, CE only, dropout 0,
the port's seed-0 weights (carried to flax by ``variables_from_port``), a
global batch of 4 pairs of 64x128, one Adam step. Both packages run in
float64 (the JAX package under ``jax.enable_x64``, its s2d heads off): in
fp32 one pixel's head-1/head-2 argmax sits on a near-tie of the random-init
logits, and Adam's first update, lr * g / (|g| + eps), moves a parameter by
2 lr where fp32 rounding flips a tiny gradient's sign, so the fp32 steps
differ by 3e-3 in places whatever the reduction. With BatchNorm
cross-replica (``sync``, the JAX model's ``axis_name="data"``) and per
replica (``local``, ``axis_name=None``): the loss within 2e-4 relative, the
summed metrics (``conf1``, ``conf2``, ``disp_err3px``, ``disp_valid``)
exactly, every updated parameter within 1e-4, every gradient within 1e-6 *
max|ref| (read from Adam's first moment in the JAX package), every running
statistic within 1e-4 * max|ref|: the JAX package's own invariance bounds
(``tests/test_training.py``), the gradients' the float64 step tests'. The
sharded eval's per-row metrics equal the one-process eval's exactly and the
JAX sharded eval step's within 1e-9 relative.
"""
import copy

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port import (  # noqa: F401
    ADAM_B1,
    flax_stats_to_port,
    flax_to_port,
    join_ranks,
    numpy_batch,
    reduced_depth,
    start_ranks,
    torch_threads,
    variables_from_port,
    worst_relative,
)
from torch_ddp_worker import step_config

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    TrainState,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import training as jtraining
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.parallel import (
    make_mesh,
    replicate,
    shard_batch,
)

RANKS = 2
SHAPE = (4, 64, 128)  # the global batch
SUMS = ("conf1", "conf2", "disp_err3px", "disp_valid")
MODES = {"sync": "data", "local": None}  # BatchNorm mode -> the JAX model's axis_name


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_mesh(port, batch):
    """The JAX package in float64 on a 2-device mesh from the port's
    weights: {mode: (metrics, parameters, gradients, statistics)} after one
    step, and the sharded eval step's per-row metrics at the initial
    weights."""
    cfg = JaxConfig()
    cfg.model.net, cfg.loss.losses, cfg.model.dropout = "sdnet_mini", ("cross_entropy",), 0.0
    cfg.model.s2d_heads = False
    mesh = make_mesh(n_devices=RANKS)
    key = jax.random.PRNGKey(0)
    out = {}
    with jax.enable_x64(True):
        for mode, axis_name in MODES.items():
            model = jmodels.get_network(cfg, axis_name=axis_name)
            variables = _f64(variables_from_port(
                port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
                key, batch["left"][:1], batch["right"][:1]))
            tx = jtraining.build_optimizer(cfg.optim, cfg.model.net, 1, 1)
            state = replicate(mesh, jtraining.TrainState.create(
                model.apply, variables["params"], variables["batch_stats"], tx))
            state, metrics = jtraining.make_train_step(cfg, model, mesh)(
                state, shard_batch(mesh, _f64(batch)), key)
            adam = [s for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
            grads = {n: m / (1 - ADAM_B1) for n, m in flax_to_port(adam[0].mu).items()}
            out[mode] = ({k: np.asarray(v) for k, v in metrics.items()},
                         flax_to_port(state.params), grads, flax_stats_to_port(state.batch_stats))
        _, rows = jtraining.make_eval_step(cfg, model, mesh)(
            variables["params"], variables["batch_stats"], shard_batch(mesh, _f64(batch)), key)
        out["eval"] = {k: np.asarray(v) for k, v in rows.items()}
    return out


def _port_one_process(port, batch):
    """The port's float64 step and eval on the global batch in this
    process."""
    cfg = step_config()
    model = copy.deepcopy(port).double()
    tensors = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    rows = make_eval_step(cfg, copy.deepcopy(model), "cpu")(tensors)[1]
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, 1))
    _, metrics = make_train_step(cfg, model, "cpu")(state, tensors)
    return ({k: v.numpy() for k, v in metrics.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()},
            {n: b.numpy() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))},
            {k: v.numpy() for k, v in rows.items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_step")
    batch = numpy_batch(0, SHAPE)
    np.savez(tmp / "batch.npz", **batch)
    # the ranks run while this process compiles and runs the JAX mesh steps
    handle = start_ranks(RANKS, tmp, task="step", batch=str(tmp / "batch.npz"))
    try:
        with reduced_depth():
            port = tmodels.get_network(step_config(), device="cpu", seed=0)
            out = {"jax": _jax_mesh(port, batch), "one": _port_one_process(port, batch)}
    finally:
        ranks = join_ranks(handle)
    return {"ranks": ranks, **out}


@pytest.mark.parametrize("mode", MODES)
def test_loss_matches_jax_mesh(run, mode):
    got, ref = float(run["ranks"][0][mode][0]["loss"]), float(run["jax"][mode][0]["loss"])
    assert np.isfinite(got) and abs(got - ref) <= 2e-4 * abs(ref), (got, ref)


@pytest.mark.parametrize("mode", MODES)
def test_summed_metrics_match_jax_mesh_exactly(run, mode):
    got, ref = run["ranks"][0][mode][0], run["jax"][mode][0]
    for k in SUMS:
        assert np.array_equal(got[k], ref[k]), (k, got[k], ref[k])
    assert got["conf2"].sum() == np.prod(SHAPE)  # every pixel of the global batch, once


@pytest.mark.parametrize("mode", MODES)
def test_params_and_grads_match_jax_mesh(run, mode):
    _, params, grads, _ = run["ranks"][0][mode]
    _, ref_params, ref_grads, _ = run["jax"][mode]
    assert set(params) == set(ref_params)
    worst = max((np.abs(params[n] - r).max(), n) for n, r in ref_params.items())
    assert worst[0] <= 1e-4, worst
    worst = worst_relative({n: grads[n] for n in ref_grads}, ref_grads)
    assert worst[0] <= 1e-6, worst


@pytest.mark.parametrize("mode", MODES)
def test_running_stats_match_jax_mesh(run, mode):
    stats, ref = run["ranks"][0][mode][3], run["jax"][mode][3]
    worst = worst_relative(stats, ref)
    assert worst[0] <= 1e-4, worst
    # the replicas end equal: the same update, the same averaged statistics
    other = run["ranks"][1][mode]
    for mine, theirs in zip(run["ranks"][0][mode][1:], other[1:]):
        assert all(np.array_equal(mine[n], theirs[n]) for n in mine)


def test_two_ranks_equal_one_process_on_the_global_batch(run):
    metrics, params, _, stats = run["ranks"][0]["sync"]
    ref_metrics, ref_params, ref_stats, _ = run["one"]
    loss, ref_loss = float(metrics["loss"]), float(ref_metrics["loss"])
    assert abs(loss - ref_loss) <= 2e-4 * abs(ref_loss), (loss, ref_loss)
    for k in SUMS:
        assert np.array_equal(metrics[k], ref_metrics[k]), k
    worst = max((np.abs(params[n] - r).max(), n) for n, r in ref_params.items())
    assert worst[0] <= 1e-4, worst
    worst = worst_relative(stats, ref_stats)
    assert worst[0] <= 1e-4, worst


def test_sharded_eval_rows(run):
    rows, one, ref = run["ranks"][0]["eval"], run["one"][3], run["jax"]["eval"]
    assert set(rows) == set(one) and set(ref) <= set(rows)
    for k in one:
        assert rows[k].shape[0] == SHAPE[0] and np.array_equal(rows[k], one[k]), k
        assert np.array_equal(run["ranks"][1]["eval"][k], rows[k]), k
    for k, r in ref.items():
        if k in SUMS:
            assert np.array_equal(rows[k], r), k
        else:
            assert np.abs(rows[k] - r).max() <= 1e-9 * max(np.abs(r).max(), 1.0), k
