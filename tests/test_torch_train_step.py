"""The port's train step (``TrainState`` + ``make_train_step``) against the
JAX package's ``make_train_step(cfg, model, mesh=None)``: the flagship
(sdnet_mini_ext, 1dcorr, aspp 0, attention gates) with the bench's loss
stack CE + Lovász + MultiTversky + OHEM and Adam, from the same variables,
on the CPU at 1x64x128, the
trunk at block config (2, 2, 2, 2) (``torch_port.reduced_depth``; the
full-depth step runs on the card in ``chip_smoke.py``).

The reference is the JAX package in float64 (``jax.enable_x64``): two steps
of its ``make_train_step``, and the step-0 gradient that step takes (read
from Adam's first moment after step 0). The variables are the port's seeded
weights (seed 0) as a flax tree (``torch_port.variables_from_port``),
carried into a second port model (seed 1) by ``load_jax_variables``. Two steps of the port's
``make_train_step`` in fp32 are held to the JAX package's own trajectory
bounds (``tests/test_trajectory_parity.py``): the step-0 loss within 2e-4
relative and the BatchNorm running statistics after step 0 within
1e-4 * max|ref| per tensor. Two steps on a float64 copy of the port are held
tightly: both losses and the statistics within 1e-9, every gradient tensor
within 1e-6 * max|ref| (measured: 4e-10).

Why the gradients and step 1 are held in float64: train-mode BatchNorm makes
this net's gradient ill-conditioned in fp32. The port's fp32 gradient is
~2% off its float64 one (||d|| / ||g||), up to ~10% for single tensors, with
any loss stack and at 128x256 too; with BatchNorm frozen and inputs small
enough that no softmax saturates, it is within 3e-6 per tensor. Adam's
first update, about lr * sign(g), then carries that noise into the step-1
loss. In float64 the two packages agree to ~4e-10 per tensor. Two details
of the JAX package round to fp32 under x64, and the reference avoids them:
its s2d heads (``s2d_heads``, the same function; ``tests/test_s2d.py``) take
their batch statistics in fp32, so the reference runs the plain heads; and
``focal_binary_tversky``'s backward returns fp32, which a float64
``custom_vjp`` refuses, so the reference runs the same forward and backward
with that result cast to float64.
"""
import copy

import jax
import numpy as np
import pytest
import torch
from torch_port import (  # noqa: F401
    STACK,
    jax_float64_reference,
    numpy_batch,
    port_config,
    port_grads,
    port_stats,
    port_steps,
    reduced_depth,
    torch_threads,
    variables_from_port,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    TrainState,
    build_optimizer,
    compute_metrics,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig

SHAPE = (1, 64, 128)


@pytest.fixture(scope="module")
def run():
    batch = numpy_batch()
    key = jax.random.PRNGKey(0)
    with reduced_depth():
        jcfg = JaxConfig()
        jcfg.loss.losses = STACK
        model = jmodels.get_network(jcfg)
        cfg = port_config()
        variables = variables_from_port(
            tmodels.get_network(cfg, device="cpu", seed=0),
            lambda k, a, b: model.init({"params": k}, a, b, train=False), key, batch["left"], batch["right"])
        jax_grads, jax_loss, jax_stats = jax_float64_reference(variables, batch, key)

        port = tmodels.get_network(cfg, device="cpu", seed=1)
        tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
        port64 = copy.deepcopy(port).double()
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, _, stats, metrics = port_steps(cfg, port, tbatch)
        loss64, grads64, stats64, _ = port_steps(cfg, port64, {k: v.double() for k, v in tbatch.items()})
    return {"jax_loss": jax_loss, "jax_grads": jax_grads, "jax_stats": jax_stats,
            "loss": loss, "stats": stats, "metrics": metrics,
            "loss64": loss64, "grads64": grads64, "stats64": stats64}


def test_step0_loss_matches_jax(run):
    """fp32 within 2e-4 relative; float64 within 1e-9."""
    ref = run["jax_loss"][0]
    assert np.isfinite(run["loss"][0]) and abs(run["loss"][0] - ref) <= 2e-4 * abs(ref), (run["loss"], ref)
    assert abs(run["loss64"][0] - ref) <= 1e-9 * abs(ref), (run["loss64"], ref)


def test_step1_loss_matches_jax(run):
    """float64 within 1e-9 relative. The fp32 step-1 loss is only held finite:
    Adam's first update is about lr * sign(g), so the fp32 gradient noise
    flips the steps of the entries it swamps, and the fp32 step-1 losses of
    two implementations (or of one at another thread count) differ by up to
    ~4e-3."""
    ref = run["jax_loss"][1]
    assert np.isfinite(run["loss"][1])
    assert abs(run["loss64"][1] - ref) <= 1e-9 * abs(ref), (run["loss64"], ref)


def test_step0_gradients_match_jax_in_float64(run):
    """Every tensor within 1e-6 * max|ref|; the float64 rounding, amplified
    as in fp32 (about 1e6 times), reaches ~4e-10."""
    ref, got = run["jax_grads"], run["grads64"]
    assert set(got) == set(ref)  # every port parameter has a JAX gradient and back
    tiny = np.finfo(np.float64).tiny
    worst = max((np.abs(got[n] - r).max() / max(np.abs(r).max(), tiny), n) for n, r in ref.items())
    assert worst[0] <= 1e-6, worst


def test_step0_bn_running_stats_match_jax(run):
    """fp32 within 1e-4 * max|ref| per tensor; float64 within 1e-9."""
    ref = run["jax_stats"]
    for got, tol in ((run["stats"], 1e-4), (run["stats64"], 1e-9)):
        assert set(got) == set(ref)
        for name, r in ref.items():
            assert np.abs(got[name] - r).max() <= tol * np.abs(r).max(), (name, tol)


def test_train_metrics_are_the_metric_pack_and_the_loss_logs(run):
    m = run["metrics"]
    keys = set(compute_metrics(PMTConfig(), {k: torch.zeros(SHAPE + (c,)) for k, c in
                                             (("seg1", 2), ("seg2", 2), ("disp1", 1))},
                               {"seg": torch.zeros(SHAPE + (2,)), "disp": torch.zeros(SHAPE + (1,))}))
    assert set(m) == keys | {"loss", "loss_seg", "loss_disp"}
    assert float(m["conf1"].sum()) == float(m["conf2"].sum()) == np.prod(SHAPE)
    assert all(torch.isfinite(v).all() for v in m.values())


@pytest.fixture(scope="module")
def small_port():
    with reduced_depth():
        return tmodels.get_network(port_config(), device="cpu", seed=1)


def one_step(model, cfg):
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, len(STACK)))
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(2).items()}
    _, metrics = make_train_step(cfg, model, device="cpu")(state, batch)
    return metrics


def is_bn(name, model):
    return isinstance(model.get_submodule(name.rsplit(".", 1)[0]), torch.nn.BatchNorm2d)


def test_freeze_bn_zeroes_exactly_the_bn_grads(small_port):
    live, frozen = copy.deepcopy(small_port), copy.deepcopy(small_port)
    one_step(live, port_config())
    stats = port_stats(frozen)
    one_step(frozen, port_config(freeze_bn=True))
    live_g, frozen_g = port_grads(live), port_grads(frozen)
    bn = {n for n in frozen_g if is_bn(n, frozen)}
    assert bn and all(not frozen_g[n].any() for n in bn)
    assert any(live_g[n].any() for n in bn)
    # every other parameter that learns without freeze_bn learns with it
    assert all(frozen_g[n].any() for n in live_g if n not in bn and live_g[n].any())
    # and BatchNorm ran on its running statistics, which stay as they were
    assert all(np.array_equal(v, stats[n]) for n, v in port_stats(frozen).items())


def test_bf16_policy_keeps_fp32_masters(small_port):
    model = copy.deepcopy(small_port)
    stats = port_stats(model)
    cfg = port_config()
    cfg.parallel.bf16 = True
    metrics = one_step(model, cfg)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
    # the running statistics moved in the fp32 master buffers
    after = port_stats(model)
    assert all(np.isfinite(v).all() for v in after.values())
    assert sum(not np.array_equal(v, stats[n]) for n, v in after.items()) == len(stats)


def test_train_step_needs_a_card_unless_told_cpu(small_port):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(port_config(), copy.deepcopy(small_port))
