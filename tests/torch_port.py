"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

* ``OPTION_CONFIGS`` names the flagship family's option configurations.
* ``reduced_depth()`` runs every trunk shallow in both packages (the
  registry entries of each, and the dlab net's ResNet-101): the densenets at
  block config (2, 2, 2, 2) with their own growth and initial features, the
  ResNets at ``layers=(1, 1, 1, 3)``, EfficientNet with one block a stage,
  MobileNetV3 whole (it is small), so a JAX reference of a whole net traces
  and compiles in seconds. Widths, heads, the pyramid, the weight mapping
  and the patch choice are those of the full net; full depth is held by the
  flagship's eval fixture and on the card.
* ``torch_threads`` (from ``port_threads``) caps torch's CPU threads for a
  test module: the suite runs several workers on one machine, each with its
  own thread pools.
* ``flax_to_port(tree)`` renames a flax tree (gradients or parameters) to the
  port's parameter names, kernels in the port's (O, I, kh, kw) layout.
* ``variables_from_port(port, init, *args)`` is the flax variable tree that
  ``init(*args)`` would make, filled with the port model's own weights (the
  JAX package's initialisers, drawn by ``get_network``): the shapes come from
  ``jax.eval_shape``, which traces ``init`` without compiling it (a flax
  init's compile is the costliest part of a reference on the CPU).
* ``check_per_view_batch_norm(port, left, right, head_bn)`` checks a net's
  train-mode forward: the trunk runs once per view, left then right.
* ``compare_net`` runs a whole net's eval forward in both packages;
  ``check_trunk(name)`` holds one trunk in eval and train mode.
* ``float64_steps(net, corr_type)`` holds the port's ``make_train_step``
  against the JAX package's in float64 (two steps from the same variables
  and batch, the bench loss stack, Adam; see ``jax_float64_reference``).
* ``float64_convolutions_as_dots()`` compiles the JAX package's float64
  convolutions on the CPU as strided windows and one matmul each, the same
  sums that XLA's own loops take ~25x longer over.
* ``spawn_ranks(world, out_dir, **spec)`` runs ``torch_ddp_worker.py`` as
  the ranks of one gloo group on the CPU and returns what each computed;
  ``start_ranks``/``join_ranks`` split it, so a caller can work while the
  ranks run.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax._src.interpreters import mlir
import optax
import pytest
import torch
from port_threads import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.registry import (
    BACKBONES as TORCH_BACKBONES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet as td
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import efficientnet as te
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import init_parameters
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import resnet_deeplab as tr
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import sdnet_dlab as tdlab
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
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import efficientnet as je
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import resnet_deeplab as jr
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import sdnet_dlab as jdlab

REDUCED_BLOCKS = (2, 2, 2, 2)
# the flagship family's options, combined where the flags allow (name ->
# (net, model options)): the configurations of test_torch_sdnet_options.py
# and test_torch_pth_import.py
OPTION_CONFIGS = {
    "v2_aspp1_no_dec1": ("sdnet_mini_ext_v2", {"aspp": 1, "ablation": ("no_dec1",)}),
    "piramid_att0_cdo2_hanet1": ("sdnet_mini_ext_piramid", {
        "use_att": False, "conv_deconv_out": 2, "hanet": True, "hanet_is_encoding": 1}),
    "piramid_res_no_dec3_cdo1_hanet0": ("sdnet_mini_ext_piramid_res", {
        "ablation": ("no_dec3",), "conv_deconv_out": 1, "hanet": True, "hanet_is_encoding": 0}),
    "aspp2": ("sdnet_mini_ext", {"aspp": 2}),
    "multitask1": ("sdnet_mini_ext", {"multaskloss": 1}),
    "multitask2": ("sdnet_mini_ext", {"multaskloss": 2}),
}
ADAM_B1 = 0.9  # optax.adam's default, the JAX package's Adam


# the densenets' (growth, initial features) and the other trunks' cuts
DENSENETS = {"densenet": (32, 64), "dn169": (32, 64), "dn201": (32, 64), "dn161": (48, 96)}
REDUCED_RESNET = (1, 1, 1, 3)
REDUCED_EFFNET_DEPTH = 0.25  # ceil(0.25 * n) = 1 block a stage for every n <= 4
EFFNET_WIDTHS = {"efficientnet-b2": 1.1, "efficientnet-b3": 1.2, "efficientnet-b4": 1.4,
                 "efficientnet-b5": 1.6}


def _reduced_makers(name):
    """(JAX factory, port factory) of trunk ``name`` at reduced depth."""
    if name in DENSENETS:
        growth, init = DENSENETS[name]
        return (lambda axis_name=None, name=None: jd.DenseNetFeatures(
                    REDUCED_BLOCKS, growth, init, axis_name=axis_name, name=name),
                lambda in_channels=3: td.DenseNetFeatures(REDUCED_BLOCKS, growth, init,
                                                          in_channels))
    if name in ("resnet50", "resnet101"):
        return (lambda axis_name=None, name=None: jr.ResNetDeeplabFeatures(
                    REDUCED_RESNET, 16, axis_name=axis_name, name=name),
                lambda in_channels=3: tr.ResNetDeeplabFeatures(REDUCED_RESNET, 16,
                                                               in_channels=in_channels))
    width = EFFNET_WIDTHS[name]
    return (lambda axis_name=None, name=None: je.EfficientNetFeatures(
                width, REDUCED_EFFNET_DEPTH, axis_name=axis_name, name=name),
            lambda in_channels=3: te.EfficientNetFeatures(width, REDUCED_EFFNET_DEPTH, in_channels))


def _reduced_dlab(module):
    """``module.ResNetDeeplabFeatures`` of a dlab module, cut to
    ``REDUCED_RESNET``."""
    full = module.ResNetDeeplabFeatures
    return lambda layers, *args, **kw: full(REDUCED_RESNET, *args, **kw)


@contextlib.contextmanager
def reduced_depth():
    """Both packages build every trunk shallow inside (the module
    docstring); "mobilenet" stays whole."""
    with pytest.MonkeyPatch.context() as mp:
        for name in tuple(DENSENETS) + ("resnet50", "resnet101") + tuple(EFFNET_WIDTHS):
            jax_make, torch_make = _reduced_makers(name)
            mp.setitem(JAX_BACKBONES._items, name, jax_make)
            mp.setitem(TORCH_BACKBONES._items, name, torch_make)
        for module in (jdlab, tdlab):
            mp.setattr(module, "ResNetDeeplabFeatures", _reduced_dlab(module))
        yield


_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _to_flax_layout(a, leaf="kernel"):
    """A port tensor in flax's layout: conv kernels OIHW -> HWIO, 3-D kernels
    OIDHW -> DHWIO, Conv1d kernels OIk -> (k, I, O), Linear weights (O, I) ->
    Dense kernels (I, O)."""
    if a.ndim == 5:
        return a.transpose(2, 3, 4, 1, 0)
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2 and leaf == "kernel":
        return a.T
    return a.transpose(2, 1, 0) if a.ndim == 3 else a


def _from_flax_layout(a, leaf="kernel"):
    if a.ndim == 5:
        return a.transpose(4, 3, 0, 1, 2)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2 and leaf == "kernel":
        return a.T
    return a.transpose(2, 1, 0) if a.ndim == 3 else a


def _port_key(keys, names):
    """The port's name of a flax leaf path (without its collection); a
    leaf that is none of ``names`` is a free parameter (log_var_disp)."""
    if keys[-1] in names:
        return ".".join(keys[:-1] + [names[keys[-1]]])
    return ".".join(keys)


def variables_from_port(port: torch.nn.Module, init, *args) -> dict:
    """{"params": ..., "batch_stats": ...} of numpy arrays shaped as
    ``init(*args)`` returns them, holding ``port``'s weights."""
    state = port.state_dict()

    def leaf(path, shape):
        keys = [k.key for k in path]
        names = _LEAVES if keys[0] == "params" else _STATS
        a = _to_flax_layout(state[_port_key(keys[1:], names)].detach().numpy(), keys[-1])
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
                out[_port_key(list(path + (k,)), _LEAVES)] = _from_flax_layout(np.asarray(v, np.float64), k)
    walk(tree, ())
    return out



def check_per_view_batch_norm(port, left, right, head_bn, per_view_bn=(), **inputs):
    """Run ``port`` (an eval-mode net, left unchanged) in train mode on the
    NHWC numpy images and check that it runs the trunk once per view, left
    then right: each pass normalises by its own view's batch statistics and
    moves the running statistics, so they move twice in that order (flax
    momentum 0.9, biased variance), while ``head_bn`` (the name of a head's
    BatchNorm) moves once. The BatchNorms named in ``per_view_bn`` (a module
    shared by both views, e.g. aspp 2's ASPP) move twice, as the trunk's do.
    ``inputs`` are the model's keyword inputs. Returns the outputs."""
    port = copy.deepcopy(port).train()
    trunk = getattr(port.features, "backbone", None) or port.features.trunk
    conv0 = next(m for m in trunk.modules() if isinstance(m, torch.nn.Conv2d))
    norm0 = next(m for m in trunk.modules() if isinstance(m, torch.nn.BatchNorm2d))
    bns = {"trunk": norm0, "head": port.get_submodule(head_bn)}
    bns.update((name, port.get_submodule(name)) for name in per_view_bn)
    seen = {key: [] for key in bns}
    for key, bn in bns.items():
        bn.register_forward_pre_hook(lambda m, args, key=key: seen[key].append(args[0].detach().clone()))
    before = {k: (bn.running_mean.clone(), bn.running_var.clone()) for k, bn in bns.items()}
    out = port(torch.from_numpy(left), torch.from_numpy(right), **inputs)
    nb = left.shape[0]
    assert [x.shape[0] for x in seen["trunk"]] == [nb, nb]  # L, then R
    assert [x.shape[0] for x in seen["head"]] == [nb]
    for name in per_view_bn:
        assert [x.shape[0] for x in seen[name]] == [nb, nb]
    for key, bn in bns.items():
        mean, var = before[key]
        for x in seen[key]:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = 0.9 * mean + 0.1 * x.mean(dim=dims)
            var = 0.9 * var + 0.1 * x.var(dim=dims, unbiased=False)
        torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-6)
    # the left view's pass is the trunk's first conv on the left image (its
    # first three channels, unless the trunk takes the edge channel too)
    image = torch.from_numpy(left[..., :conv0.in_channels]).permute(0, 3, 1, 2)
    torch.testing.assert_close(seen["trunk"][0], conv0(image).detach(), rtol=1e-5, atol=1e-5)
    return out


def net_configs(net, **options):
    """(JAX config, port config) of ``net`` with the model options."""
    cfgs = (JaxConfig(), PMTConfig())
    for cfg in cfgs:
        cfg.model.net = net
        for k, v in options.items():
            setattr(cfg.model, k, v)
    return cfgs


def compare_net(net, left, right, jax_kw=None, torch_kw=None, **options):
    """The eval forward of ``net`` at ``reduced_depth`` in both packages on
    the NHWC numpy images, the port's seeded weights carried to flax and
    back (``load_jax_variables``): (JAX outputs, port outputs) as numpy, and
    the port model. ``jax_kw``/``torch_kw``: the models' keyword inputs."""
    jax_kw, torch_kw = jax_kw or {}, torch_kw or {}
    jcfg, cfg = net_configs(net, **options)
    with reduced_depth():
        port = tmodels.get_network(cfg, device="cpu", seed=0)
        model = jmodels.get_network(jcfg)
        variables = variables_from_port(
            port, lambda k, a, b: model.init({"params": k}, a, b, train=False, **jax_kw),
            jax.random.PRNGKey(0), left, right)
        ref = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False, **jax_kw))(
            variables, left, right)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = port(torch.from_numpy(left), torch.from_numpy(right), **torch_kw)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: np.asarray(v) for k, v in got.items()}, port)


def worst_output(ref: dict, got: dict):
    """(max|got - ref| / max|ref|, key) over the outputs; both dicts hold the
    same keys and shapes."""
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, (k, got[k].shape, ref[k].shape)
        assert np.isfinite(got[k]).all(), k
    return max((np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max(), k) for k in ref)


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


def _conv_as_dots(lhs, rhs, *, window_strides, padding, lhs_dilation, rhs_dilation,
                  dimension_numbers, **_):
    """``lax.conv_general_dilated`` with one feature and one batch group,
    written as x's dilated and padded windows and one ``dot_general``: for
    each spatial dim, stacked over its kernel taps (a strided slice of the
    output positions each) or, where the output is the shorter, over its
    output positions (a window of the kernel's extent each)."""
    lhs_spec, rhs_spec, out_spec = dimension_numbers
    x = jnp.transpose(lhs, lhs_spec)  # (N, C, *spatial)
    w = jnp.transpose(rhs, rhs_spec)  # (O, C, *kernel)
    nd = x.ndim - 2
    zero = np.zeros((), x.dtype)
    x = lax.pad(x, zero, [(0, 0, 0)] * 2 + [(0, 0, d - 1) for d in lhs_dilation])
    x = lax.pad(x, zero, [(0, 0, 0)] * 2 + [(lo, hi, 0) for lo, hi in padding])
    kernel = w.shape[2:]
    out = tuple((s - (k - 1) * d - 1) // st + 1
                for s, k, d, st in zip(x.shape[2:], kernel, rhs_dilation, window_strides))
    taps = []
    for i, (k, m, d, st) in enumerate(zip(kernel, out, rhs_dilation, window_strides)):
        ax = 2 + 2 * i  # the dims before it are two axes each by now

        def window(first, size, step):
            start, limit, strides = [0] * x.ndim, list(x.shape), [1] * x.ndim
            start[ax], limit[ax], strides[ax] = first, first + (size - 1) * step + 1, step
            return lax.slice(x, start, limit, strides)

        if k <= m:
            x = jnp.stack([window(t * d, m, st) for t in range(k)], ax)
            taps.append(ax)
        else:
            x = jnp.stack([window(p * st, k, d) for p in range(m)], ax)
            taps.append(ax + 1)
    y = lax.dot_general(x, w, (((1, *taps), tuple(range(1, 2 + nd))), ((), ())))  # (N, *out, O)
    return jnp.transpose(jnp.moveaxis(y, -1, 1), np.argsort(out_spec))


@contextlib.contextmanager
def float64_convolutions_as_dots():
    """Inside the block, the CPU lowering of ``lax.conv_general_dilated``
    (forward and both transposes) takes float64 operands with one feature
    and one batch group through ``_conv_as_dots``; every other convolution
    keeps XLA's own. XLA's CPU backend runs float64 convolutions as plain
    loops: one 5x5, 64-channel gradient at 1x64x128 takes 2.0 s against
    0.08 s in fp32, and the JAX package's float64 train step of
    ``sdnet_mini`` at reduced depth 5.5 s a step on 7 cores. As windows and
    matmuls the same sums, in another order, take ~1.4 s
    (``tests/test_torch_float64_convs.py`` holds the two lowerings within
    1e-13). The JAX package's programs are unchanged; only how XLA compiles
    their float64 convolutions on the CPU."""
    table = mlir._platform_specific_lowerings["cpu"]
    held = table[lax.conv_general_dilated_p]

    def rule(ctx, lhs, rhs, **params):
        if (all(a.dtype == np.float64 for a in ctx.avals_in)
                and params["feature_group_count"] == params["batch_group_count"] == 1):
            return mlir.lower_fun(functools.partial(_conv_as_dots, **params),
                                  multiple_results=False)(ctx, lhs, rhs)
        return held.rule(ctx, lhs, rhs, **params)

    table[lax.conv_general_dilated_p] = mlir.LoweringRuleEntry(rule, held.inline)
    try:
        yield
    finally:
        table[lax.conv_general_dilated_p] = held


def jax_float64_reference(variables, batch, key, net="sdnet_mini_ext", corr_type="1dcorr",
                          losses=STACK):
    """The JAX package in float64 (``jax.enable_x64``): two steps of its
    ``make_train_step`` (the two losses, the BatchNorm running statistics
    after step 0) with the loss stack ``losses``, and the step-0 gradient
    that step takes ({port name: gradient}), read from Adam's first moment
    after step 0 (``(1 - b1) * g`` from zero, so ``g`` to one rounding): one
    compiled program, traced once for both steps.
    Two details of the JAX package round to fp32
    under x64, and the reference avoids them: its s2d heads take their batch
    statistics in fp32, so it runs the plain heads (the same function,
    ``tests/test_s2d.py``); and ``focal_binary_tversky``'s backward returns
    fp32, which a float64 ``custom_vjp`` refuses, so it runs the same forward
    and backward with that result cast to float64. Its float64
    convolutions compile as windows and matmuls
    (``float64_convolutions_as_dots``). Call it inside ``reduced_depth()``."""
    cfg = JaxConfig()
    cfg.model.net = net
    cfg.model.corr_type = corr_type
    cfg.loss.losses = losses
    cfg.model.s2d_heads = False
    model = jmodels.get_network(cfg)
    # numpy casts: a jnp cast compiles once for each shape
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64(True), float64_convolutions_as_dots(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtversky, "focal_binary_tversky", _tversky_float64)
        params, stats, batch = f64(variables["params"]), f64(variables["batch_stats"]), f64(batch)
        tx = jtraining.build_optimizer(cfg.optim, cfg.model.net, len(losses), 1)
        # arrays everywhere (the step count too), so that step 1 reuses step 0's trace
        state = jax.tree_util.tree_map(jnp.asarray, jtraining.TrainState.create(model.apply, params, stats, tx))
        step = jtraining.make_train_step(cfg, model, mesh=None)
        state, m0 = step(state, batch, key)
        adam = [s for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        assert len(adam) == 1
        assert all(a.dtype == jnp.float64 for a in jax.tree_util.tree_leaves(adam[0].mu))
        grads = {n: m / (1 - ADAM_B1) for n, m in flax_to_port(adam[0].mu).items()}
        stats0 = flax_stats_to_port(state.batch_stats)
        state, m1 = step(state, batch, key)
        return grads, (float(m0["loss"]), float(m1["loss"])), stats0


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


# ---- one trunk against the JAX trunk (test_torch_trunks*.py) ----
# One trunk of each package at ``reduced_depth``, the port's seeded weights
# carried to flax, compared at 1x64x128 (even H and W, so EfficientNet's
# stride-2 SAME convs pad asymmetrically), in eval mode and in train mode
# (batch statistics, and the running statistics each BatchNorm moves to:
# flax momentum 0.9, EfficientNet's 0.99). Bound: max|port - jax| <= 1e-4 *
# max|jax| per tap and running variance, and per running mean 1e-4 of the
# larger of max|jax| and its layer's running standard deviation
# (``_stat_error``).
TRUNK_REL = 1e-4
TRUNK_SHAPE = (1, 64, 128, 3)
# HANet's ResNet3X3 at output stride 8, the dlab net's trunk
DLAB_TRUNK = "resnet101-3x3x3-os8"


def _trunk_pair(name):
    """(JAX trunk, port trunk with seeded weights) at reduced depth."""
    with reduced_depth():
        if name == DLAB_TRUNK:
            jax_trunk = jr.ResNetDeeplabFeatures(REDUCED_RESNET, 8, stem="3x3x3", multigrid=False)
            port = tr.ResNetDeeplabFeatures(REDUCED_RESNET, 8, stem="3x3x3", multigrid=False)
        else:
            jax_trunk, port = JAX_BACKBONES.get(name)(), TORCH_BACKBONES.get(name)()
    init_parameters(port, torch.Generator().manual_seed(0))
    return jax_trunk, port.eval()


def _worst(got, ref):
    return max(float(np.abs(g - r).max() / np.abs(r).max()) for g, r in zip(got, ref))


def check_trunk(name):
    """Eval taps, train taps and running statistics of trunk ``name``
    against the JAX trunk; returns the worst relative error of each."""
    jax_trunk, port = _trunk_pair(name)
    x = np.random.default_rng(0).standard_normal(TRUNK_SHAPE, dtype=np.float32)
    variables = variables_from_port(port, lambda k, a: jax_trunk.init({"params": k}, a, train=False),
                                    jax.random.PRNGKey(0), x)
    ref_eval = jax.jit(lambda v, a: jax_trunk.apply(v, a, train=False))(variables, x)
    ref_train, updated = jax.jit(lambda v, a: jax_trunk.apply(v, a, train=True,
                                                              mutable=["batch_stats"]))(variables, x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got_eval = port(xt)
        port.train()
        got_train = port(xt)
    assert len(got_eval) == len(ref_eval) == 5
    assert tuple(port.tap_channels) == tuple(np.shape(t)[-1] for t in ref_eval)
    nhwc = lambda taps: [np.asarray(t.permute(0, 2, 3, 1)) for t in taps]  # noqa: E731
    ref_stats = flax_stats_to_port(updated["batch_stats"])
    got_stats = port_stats(port)
    assert set(got_stats) == set(ref_stats)
    return {"eval": _worst(nhwc(got_eval), [np.asarray(t) for t in ref_eval]),
            "train": _worst(nhwc(got_train), [np.asarray(t) for t in ref_train]),
            "stats": max(_stat_error(got_stats, ref_stats, n) for n in ref_stats)}


def _stat_error(got, ref, name):
    """A running statistic's error relative to its scale: a variance's
    max|ref|; a mean's max(max|ref|, the layer's largest running standard
    deviation). (After a 1x1 conv of a map that a BatchNorm has just
    centred, a batch mean is zero to rounding, ~1e-8, and relative to its
    own max it would measure rounding only.)"""
    scale = np.abs(ref[name]).max()
    if name.endswith("running_mean"):
        scale = max(scale, np.sqrt(ref[name[:-len("mean")] + "var"]).max())
    return float(np.abs(got[name] - ref[name]).max() / scale)


# ---- EncoderDecoderNet (test_torch_encdec*.py) ----
@torch.no_grad()
def nonzero_leaves(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Give every leaf that the seeded init leaves constant a seeded random
    value, so that no weight mapping is invisible to a comparison: biases,
    norm scales and shifts, running statistics, and convolutions the JAX
    package initialises to zero (the attention's ``W``, whose zero init
    would make the attention path add exactly nothing)."""
    g = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name.endswith("num_batches_tracked"):
            continue
        noise = torch.randn(t.shape, generator=g)
        if name.endswith("running_var"):
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
        elif t.dim() == 1 and name.endswith("weight"):  # a norm's scale
            t.copy_(1.0 + 0.1 * noise)
        elif t.dim() == 1:
            t.copy_(0.1 * noise)
        elif not t.any():
            t.copy_(noise / np.sqrt(t[0].numel()))
    return model


# ---- several ranks on the CPU (test_torch_ddp_step.py, test_torch_mesh.py) ----
WORKER = Path(__file__).with_name("torch_ddp_worker.py")
RANK_TIMEOUT_S = 300


def start_ranks(world: int, out_dir, **spec):
    """Start ``torch_ddp_worker.py`` as ``world`` ranks of one gloo group on
    a free localhost port (the trunk at ``REDUCED_BLOCKS``), each told
    ``spec``, each rank's output to ``out_dir/rank<r>.log``; returns the
    handle ``join_ranks`` takes. The caller may work meanwhile."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = str(WORKER.parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), json.dumps(dict(spec, rank=r, world=world, port=port,
                                                              out=str(out_dir), blocks=REDUCED_BLOCKS))],
                stdout=log, stderr=subprocess.STDOUT, text=True, env=env))
    return procs, str(out_dir)


def join_ranks(handle) -> list:
    """Wait for the ranks ``start_ranks`` started; returns each rank's saved
    results, rank 0 first. Fails with a rank's output if one fails; kills
    every rank still running at the end."""
    procs, out_dir = handle
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{r}.log")) as log:
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log.read()[-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]


def spawn_ranks(world: int, out_dir, **spec) -> list:
    """``start_ranks`` then ``join_ranks``: each rank's saved results."""
    return join_ranks(start_ranks(world, out_dir, **spec))
