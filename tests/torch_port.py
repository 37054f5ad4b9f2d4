"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

* ``reduced_depth()`` runs the densenet121 trunk at block config (2, 2, 2, 2)
  in both packages (the registry entry "densenet" of each), so a JAX
  reference of a whole net traces and compiles in seconds. Widths, heads,
  the pyramid, the weight mapping and the patch choice are those of the full
  net; full depth is held by the flagship's eval fixture and on the card.
* ``torch_threads`` caps torch's CPU threads for a test module: the suite
  runs several workers on one machine, each with its own thread pools.
* ``flax_to_port(tree)`` renames a flax tree (gradients or parameters) to the
  port's parameter names, kernels in the port's (O, I, kh, kw) layout.
* ``variables_from_port(port, init, *args)`` is the flax variable tree that
  ``init(*args)`` would make, filled with the port model's own weights (the
  JAX package's initialisers, drawn by ``get_network``): the shapes come from
  ``jax.eval_shape``, which traces ``init`` without compiling it (a flax
  init's compile is the costliest part of a reference on the CPU).
* ``check_per_view_batch_norm(port, left, right, head_bn)`` checks a net's
  train-mode forward: the trunk runs once per view, left then right.
* ``float64_steps(net, corr_type)`` holds the port's ``make_train_step``
  against the JAX package's in float64 (two steps from the same variables
  and batch, the bench loss stack, Adam; see ``jax_float64_reference``).
"""
from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.registry import (
    BACKBONES as TORCH_BACKBONES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet as td
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    TrainState,
    build_optimizer,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import training as jtraining
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core.registry import (
    BACKBONES as JAX_BACKBONES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import tversky as jtversky
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import densenet as jd
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training.step import (
    make_loss_fn as jax_make_loss_fn,
)

REDUCED_BLOCKS = (2, 2, 2, 2)
TORCH_THREADS = 2


def _jax_reduced(axis_name=None, name=None):
    return jd.DenseNetFeatures(REDUCED_BLOCKS, 32, 64, axis_name=axis_name, name=name)


def _torch_reduced():
    return td.DenseNetFeatures(REDUCED_BLOCKS, 32, 64)


@contextlib.contextmanager
def reduced_depth():
    """Both packages build "densenet" at block config (2, 2, 2, 2) inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_BACKBONES._items, "densenet", _jax_reduced)
        mp.setitem(TORCH_BACKBONES._items, "densenet", _torch_reduced)
        yield


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def variables_from_port(port: torch.nn.Module, init, *args) -> dict:
    """{"params": ..., "batch_stats": ...} of numpy arrays shaped as
    ``init(*args)`` returns them, holding ``port``'s weights."""
    state = port.state_dict()

    def leaf(path, shape):
        keys = [k.key for k in path]
        names = _LEAVES if keys[0] == "params" else _STATS
        a = state[".".join(keys[1:-1] + [names[keys[-1]]])].detach().numpy()
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        assert a.shape == shape.shape, (keys, a.shape, shape.shape)
        return np.array(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, *args))


def flax_to_port(tree) -> dict:
    """{port parameter name: float64 numpy array} of a flax params tree."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + (k,))
            else:
                a = np.asarray(v, np.float64)
                out[".".join(path + (_LEAVES[k],))] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    walk(tree, ())
    return out



def check_per_view_batch_norm(port, left, right, head_bn):
    """Run ``port`` (an eval-mode net, left unchanged) in train mode on the
    NHWC numpy images and check that it runs the trunk once per view, left
    then right: each pass normalises by its own view's batch statistics and
    moves the running statistics, so they move twice in that order (flax
    momentum 0.9, biased variance), while ``head_bn`` (the name of a head's
    BatchNorm) moves once. Returns the outputs."""
    port = copy.deepcopy(port).train()
    trunk_bn, head_bn = port.features.backbone.norm0, port.get_submodule(head_bn)
    seen = {"trunk": [], "head": []}
    for key, bn in (("trunk", trunk_bn), ("head", head_bn)):
        bn.register_forward_pre_hook(lambda m, args, key=key: seen[key].append(args[0].detach().clone()))
    before = {k: (bn.running_mean.clone(), bn.running_var.clone())
              for k, bn in (("trunk", trunk_bn), ("head", head_bn))}
    out = port(torch.from_numpy(left), torch.from_numpy(right))
    nb = left.shape[0]
    assert [x.shape[0] for x in seen["trunk"]] == [nb, nb]  # L, then R
    assert [x.shape[0] for x in seen["head"]] == [nb]
    for key, bn in (("trunk", trunk_bn), ("head", head_bn)):
        mean, var = before[key]
        for x in seen[key]:
            mean = 0.9 * mean + 0.1 * x.mean(dim=(0, 2, 3))
            var = 0.9 * var + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-6)
    # the left view's pass is the model's conv0 on the left image
    conv0 = port.features.backbone.conv0(torch.from_numpy(left).permute(0, 3, 1, 2))
    torch.testing.assert_close(seen["trunk"][0], conv0.detach(), rtol=1e-5, atol=1e-5)
    return out


# ---- the train step in float64 against the JAX package's ----
STACK = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")  # bench.py:196-197
TRAIN_SHAPE = (1, 64, 128)


def numpy_batch(seed=0, shape=TRAIN_SHAPE):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, shape)
    return {"left": rng.standard_normal(shape + (3,), dtype=np.float32),
            "right": rng.standard_normal(shape + (3,), dtype=np.float32),
            "seg": np.eye(2, dtype=np.float32)[labels],
            "disp": rng.random(shape + (1,), dtype=np.float32)}


def port_config(net="sdnet_mini_ext", corr_type="1dcorr", losses=STACK, **optim):
    cfg = PMTConfig()
    cfg.model.net = net
    cfg.model.corr_type = corr_type
    cfg.loss.losses = losses
    for k, v in optim.items():
        setattr(cfg.optim, k, v)
    return cfg


def port_grads(model):
    return {n: np.array((p.grad if p.grad is not None else torch.zeros_like(p)).detach(), np.float64)
            for n, p in model.named_parameters()}


def port_stats(model):
    return {n: np.array(b.detach(), np.float64) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def flax_stats_to_port(tree):
    names = {"mean": "running_mean", "var": "running_var"}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        out[".".join(keys[:-1] + [names[keys[-1]]])] = np.array(leaf, np.float64)
    return out


@jax.custom_vjp
def _tversky_float64(input2, target):
    return jtversky._fwd_impl(input2, target)[0]


_tversky_float64.defvjp(
    jtversky._fwd, lambda res, g: (jtversky._bwd(res, g)[0].astype(jnp.float64), None))


def jax_float64_reference(variables, batch, key, net="sdnet_mini_ext", corr_type="1dcorr",
                          losses=STACK):
    """The JAX package in float64 (``jax.enable_x64``): the step-0 gradient
    as its ``make_train_step`` takes it ({port name: gradient}), and two
    steps of ``make_train_step`` (the two losses, the BatchNorm running
    statistics after step 0), with the loss stack ``losses``.
    Two details of the JAX package round to fp32
    under x64, and the reference avoids them: its s2d heads take their batch
    statistics in fp32, so it runs the plain heads (the same function,
    ``tests/test_s2d.py``); and ``focal_binary_tversky``'s backward returns
    fp32, which a float64 ``custom_vjp`` refuses, so it runs the same forward
    and backward with that result cast to float64. Call it inside
    ``reduced_depth()``."""
    cfg = JaxConfig()
    cfg.model.net = net
    cfg.model.corr_type = corr_type
    cfg.loss.losses = losses
    cfg.model.s2d_heads = False
    model = jmodels.get_network(cfg)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtversky, "focal_binary_tversky", _tversky_float64)
        params, stats, batch = f64(variables["params"]), f64(variables["batch_stats"]), f64(batch)
        grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(cfg, model), has_aux=True),
                          static_argnums=(4,))
        _, grads = grad_fn(params, stats, batch, key, True)
        assert all(a.dtype == jnp.float64 for a in jax.tree_util.tree_leaves(grads))
        tx = jtraining.build_optimizer(cfg.optim, cfg.model.net, len(losses), 1)
        state = jtraining.TrainState.create(model.apply, params, stats, tx)
        step = jtraining.make_train_step(cfg, model, mesh=None)
        state, m0 = step(state, batch, key)
        stats0 = flax_stats_to_port(state.batch_stats)
        state, m1 = step(state, batch, key)
        return flax_to_port(grads), (float(m0["loss"]), float(m1["loss"])), stats0


def port_steps(cfg, model, batch):
    """Two steps of the port's ``make_train_step``: the two losses, the
    gradients of step 0, the BatchNorm running statistics after step 0, and
    the metrics of step 0."""
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net,
                                                     len(cfg.loss.losses)))
    step = make_train_step(cfg, model, device="cpu")
    _, m0 = step(state, batch)
    grads0, stats0 = port_grads(model), port_stats(model)
    _, m1 = step(state, batch)
    assert state.step == 2
    return (m0["loss"].item(), m1["loss"].item()), grads0, stats0, m0


# The float64 stack of the family's train steps: the bench stack without
# MultiTversky, whose value and backward the JAX package computes in fp32 by
# design (the reference's hard-label counts). XLA's jit fuses that fp32
# arithmetic differently from the port's eager ops: one fp32 ulp in the
# loss (~2e-8 of it), and Adam's first update, about lr * g / (|g| + eps),
# amplifies the gradient entries near eps, so the step-1 losses of the two
# packages then differ by ~3e-8 (sdnetv2, the flagship with 2dcorr); the
# flagship's own test keeps the whole stack.
FLOAT64_STACK = ("cross_entropy", "lovasz_loss", "ohm_loss")


def float64_steps(net, corr_type, losses=FLOAT64_STACK):
    """Two train steps of ``net`` at ``TRAIN_SHAPE`` with the trunk at
    ``reduced_depth``, from the port's seeded weights (carried to the JAX
    package by ``variables_from_port``), with the loss stack ``losses``: the
    JAX package's in float64 (``jax_float64_reference``) and a float64 copy
    of the port's."""
    batch = numpy_batch()
    key = jax.random.PRNGKey(0)
    cfg = port_config(net, corr_type, losses)
    with reduced_depth():
        port = tmodels.get_network(cfg, device="cpu", seed=0)
        jcfg = JaxConfig()
        jcfg.model.net, jcfg.model.corr_type, jcfg.model.s2d_heads = net, corr_type, False
        model = jmodels.get_network(jcfg)
        variables = variables_from_port(
            port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
            key, batch["left"], batch["right"])
        jax_grads, jax_loss, jax_stats = jax_float64_reference(variables, batch, key, net, corr_type,
                                                               losses)
        loss64, grads64, stats64, _ = port_steps(
            cfg, copy.deepcopy(port).double(),
            {k: torch.from_numpy(v).double() for k, v in batch.items()})
    return {"jax_loss": jax_loss, "jax_grads": jax_grads, "jax_stats": jax_stats,
            "loss64": loss64, "grads64": grads64, "stats64": stats64}


def worst_relative(got: dict, ref: dict):
    """(max|got - ref| / max|ref|, name) of the tensor farthest from its
    reference; the two dicts must hold the same names."""
    assert set(got) == set(ref)
    tiny = np.finfo(np.float64).tiny
    return max((np.abs(got[n] - r).max() / max(np.abs(r).max(), tiny), n) for n, r in ref.items())
