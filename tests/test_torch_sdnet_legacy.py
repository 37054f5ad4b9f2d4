"""The port's legacy nets, ``sdnet`` (DSNet) and ``sdnetv2`` (DSNetV2, with
``1dcorr`` and ``2dcorr``), eval forward, against the JAX models at
1x64x128, fp32 on the CPU; their train-mode forward runs the trunk once per
view, as the JAX models do.

One set of variables per net (the port's seeded weights as a flax tree,
``torch_port.variables_from_port``), carried back into the port with
``load_jax_variables``, with the trunk at block config (2, 2, 2, 2) (``torch_port.reduced_depth``;
the nets' weight mapping, patch choice and heads are those of full depth,
which the card runs in ``chip_smoke.py``). Random-init outputs are large, so
the bound is relative: max|port - jax| <= 1e-3 * max|jax| per output.
"""
import copy

import jax
import numpy as np
import pytest
import torch
from torch_port import (  # noqa: F401
    check_per_view_batch_norm,
    reduced_depth,
    torch_threads,
    variables_from_port,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig

REL = 1e-3
SHAPE = (1, 64, 128, 3)
OUTPUTS = ("seg1", "seg2", "disp1", "disp2")
NETS = [("sdnet", "2dcorr"), ("sdnetv2", "1dcorr"), ("sdnetv2", "2dcorr")]


def configs(net, corr_type):
    cfgs = (JaxConfig(), PMTConfig())
    for cfg in cfgs:
        cfg.model.net = net
        cfg.model.corr_type = corr_type
    return cfgs


@pytest.fixture(scope="module", params=NETS, ids=["-".join(n) for n in NETS])
def legacy(request):
    jcfg, tcfg = configs(*request.param)
    rng = np.random.default_rng(0)
    left = rng.standard_normal(SHAPE, dtype=np.float32)
    right = rng.standard_normal(SHAPE, dtype=np.float32)
    with reduced_depth():
        model = jmodels.get_network(jcfg)
        port = tmodels.get_network(tcfg, device="cpu")
        variables = variables_from_port(
            port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
            jax.random.PRNGKey(0), left, right)
        out = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(variables, left, right)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = port(torch.from_numpy(left), torch.from_numpy(right))
    return {"ref": {k: np.asarray(out[k]) for k in OUTPUTS},
            "got": {k: v.numpy() for k, v in got.items()}, "port": port,
            "left": left, "right": right}


@pytest.mark.parametrize("key", OUTPUTS)
def test_legacy_eval_forward_matches_jax(legacy, key):
    ref, got = legacy["ref"][key], legacy["got"][key]
    assert got.shape == ref.shape == SHAPE[:3] + ((1,) if key.startswith("disp") else (2,))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_legacy_train_mode_forward_per_view_batch_norm(legacy):
    out = check_per_view_batch_norm(legacy["port"], legacy["left"], legacy["right"],
                                    "cdu4.c1.bn")
    for k in OUTPUTS:
        assert torch.isfinite(out[k]).all() and out[k].shape == legacy["got"][k].shape


@pytest.mark.parametrize("net", ["sdnet", "sdnetv2"])
def test_legacy_edges_raise(net):
    cfg = PMTConfig()
    cfg.model.net = net
    cfg.model.edges = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.get_network(cfg, device="cpu")


def test_sdnet_correlates_the_17x17_patch_whatever_the_corr_type():
    _, cfg = configs("sdnet", "1dcorr")
    model = tmodels.get_network(cfg, device="cpu")
    assert model.patch == (17, 17)
    assert model.corrConv2d.conv.in_channels == 289


def test_legacy_modules_stay_channels_last(legacy):
    """Every multi-channel map between the modules stays channels_last (the
    layout the card's convolutions take without a transpose), in eval and
    in train mode (train-mode BatchNorm may return NCHW strides for C = 1)."""
    port, bad = copy.deepcopy(legacy["port"]), []
    hooks = [m.register_forward_hook(
        lambda m, i, out, n=n: bad.extend(
            n for o in (out if isinstance(out, (tuple, list)) else (out,))
            if o.dim() == 4 and o.shape[1] > 1
            and not o.is_contiguous(memory_format=torch.channels_last)))
        for n, m in port.named_modules() if n]
    try:
        for train in (False, True):
            with torch.no_grad():
                port.train(train)(torch.zeros(SHAPE), torch.zeros(SHAPE))
    finally:
        for h in hooks:
            h.remove()
    assert not bad
