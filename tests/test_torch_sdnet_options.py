"""The flagship family's options in the port against the JAX model: the
eval forward at 1x64x128, fp32 on the CPU, trunk at ``reduced_depth``.

Seven JAX compiles, one a configuration; the options are combined where the
flags allow:

* ``_v2`` with aspp 1 and the ``no_dec1`` ablation;
* ``_piramid`` with the attention gates off, convDeconvOut 2 and HANet
  (sinusoid encoding);
* ``_piramid_res`` with ``no_dec3``, convDeconvOut 1 and HANet (learned
  embedding);
* the flagship at aspp 2 (its second, unnormalized corr1d over the two
  views' ASPP), with the JAX package's s2d heads on and off;
* multaskloss 1 and 2, whose Kendall terms ``mt`` are held too.

Weights are the port's seeded init carried to flax
(``torch_port.variables_from_port``) and back (``load_jax_variables``);
HANet's grids and the multitask ground truth are the models' keyword inputs.
Bound: max|port - jax| <= 1e-3 * max|jax| per output and term. The
train-mode forward runs the trunk once per view; at aspp 2 the shared ASPP's
BatchNorm moves twice too, and HANet's BatchNorm (over the pooled rows) once.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch_port import (  # noqa: F401
    OPTION_CONFIGS as CONFIGS,
    check_per_view_batch_norm,
    reduced_depth,
    torch_threads,
    variables_from_port,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.hanet import (
    build_pos_grid as torch_pos_grid,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models.hanet import (
    build_pos_grid as jax_pos_grid,
)

REL = 1e-3
SHAPE = (1, 64, 128, 3)
OUTPUTS = ("seg1", "seg2", "disp1", "disp2")
# (configuration, the JAX model's s2d heads): one compile each
CASES = [(name, True) for name in CONFIGS] + [("aspp2", False)]


def _inputs():
    rng = np.random.default_rng(0)
    left = rng.standard_normal(SHAPE, dtype=np.float32)
    right = rng.standard_normal(SHAPE, dtype=np.float32)
    disp = rng.random(SHAPE[:3] + (1,), dtype=np.float32)
    labels = rng.integers(0, 2, SHAPE[:3])
    return left, right, disp, labels


def _set(cfg, net, options):
    cfg.model.net = net
    for k, v in options.items():
        setattr(cfg.model, k, v)
    return cfg


def keyword_inputs(cfg, to):
    """The model's keyword inputs: HANet's grids, the multitask ground truth
    (``to`` "jax" or "torch")."""
    _, _, disp, labels = _inputs()
    kw = {}
    if cfg.model.hanet:
        kw["pos"] = jax_pos_grid(*SHAPE[1:3]) if to == "jax" else torch_pos_grid(*SHAPE[1:3])
    if cfg.model.multaskloss:
        kw["disp_gt"] = disp if to == "jax" else torch.from_numpy(disp)
        kw["seg_labels"] = labels if to == "jax" else torch.from_numpy(labels)
    return kw


@functools.lru_cache(maxsize=None)
def port_model(name):
    net, options = CONFIGS[name]
    with reduced_depth():
        return tmodels.get_network(_set(PMTConfig(), net, options), device="cpu", seed=0)


@functools.lru_cache(maxsize=None)
def compared(name, s2d):
    """(the JAX model's outputs, the port's outputs) as numpy, the port
    loaded with the flax tree made of its own weights."""
    net, options = CONFIGS[name]
    left, right, _, _ = _inputs()
    port = port_model(name)
    jcfg = _set(JaxConfig(), net, options)
    jcfg.model.s2d_heads = s2d
    jkw = keyword_inputs(jcfg, "jax")
    with reduced_depth():
        model = jmodels.get_network(jcfg)
        variables = variables_from_port(
            port, lambda k, a, b: model.init({"params": k}, a, b, train=False, **jkw),
            jax.random.PRNGKey(0), left, right)
        ref = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False, **jkw))(variables, left, right)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = port(torch.from_numpy(left), torch.from_numpy(right),
                   **keyword_inputs(jcfg, "torch"))
    as_np = lambda out: {k: (tuple(np.asarray(t) for t in v) if k == "mt" else np.asarray(v))  # noqa: E731
                         for k, v in out.items()}
    return as_np(ref), as_np(got)


@pytest.mark.parametrize("name,s2d", CASES)
def test_options_eval_forward_matches_jax(name, s2d):
    ref, got = compared(name, s2d)
    assert set(got) == set(ref) == set(OUTPUTS) | ({"mt"} if "multitask" in name else set())
    for key in OUTPUTS:
        assert got[key].shape == ref[key].shape == SHAPE[:3] + ((1,) if key.startswith("disp") else (2,))
        assert np.isfinite(got[key]).all()
        assert np.abs(got[key] - ref[key]).max() <= REL * np.abs(ref[key]).max(), key
    for i, (a, b) in enumerate(zip(got.get("mt", ()), ref.get("mt", ()))):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= REL * np.abs(b).max(), f"mt[{i}]"


@pytest.mark.parametrize("name,head_bn,per_view_bn", [
    ("aspp2", "cdu4.c1.bn", ("aspp.proj_bn", "aspp.gp_bn")),
    ("piramid_att0_cdo2_hanet1", "hanet_last.att1_bn", ()),
])
def test_options_train_mode_per_view_batch_norm(name, head_bn, per_view_bn):
    """The trunk (and aspp 2's shared ASPP) once per view, left then right;
    a head's BatchNorm (HANet's over its pooled rows) once."""
    left, right, _, _ = _inputs()
    cfg = _set(PMTConfig(), *CONFIGS[name])
    out = check_per_view_batch_norm(port_model(name), left, right, head_bn, per_view_bn,
                                    **keyword_inputs(cfg, "torch"))
    assert all(torch.isfinite(out[k]).all() and out[k].shape[:3] == SHAPE[:3] for k in OUTPUTS)
