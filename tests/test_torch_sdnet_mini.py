"""The port's ``sdnet_mini`` (MiniDSNet) eval forward, with ``1dcorr`` and
``2dcorr``, against the JAX model at 1x64x128, fp32 on the CPU.

One set of variables per correlation type (the port's seeded weights as a
flax tree, ``torch_port.variables_from_port``), carried back into the port
with ``load_jax_variables``, with the trunk at block config (2, 2, 2, 2)
(``torch_port.reduced_depth``); the JAX model runs with ``s2d_heads`` on and
off (the same variables fit both). The bound is relative: max|port - jax| <=
1e-3 * max|jax| per output. Its train-mode forward runs the trunk once per
view, as the JAX model does.
"""
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


@pytest.fixture(scope="module", params=["1dcorr", "2dcorr"])
def mini(request):
    rng = np.random.default_rng(0)
    left = rng.standard_normal(SHAPE, dtype=np.float32)
    right = rng.standard_normal(SHAPE, dtype=np.float32)
    refs, variables = {}, None
    with reduced_depth():
        cfg = PMTConfig()
        cfg.model.net = "sdnet_mini"
        cfg.model.corr_type = request.param
        port = tmodels.get_network(cfg, device="cpu")
        for s2d in (True, False):
            cfg = JaxConfig()
            cfg.model.net = "sdnet_mini"
            cfg.model.corr_type = request.param
            cfg.model.s2d_heads = s2d
            model = jmodels.get_network(cfg)
            if variables is None:
                variables = variables_from_port(
                    port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
                    jax.random.PRNGKey(0), left, right)
            out = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(variables, left, right)
            refs[s2d] = {k: np.asarray(out[k]) for k in OUTPUTS}
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = port(torch.from_numpy(left), torch.from_numpy(right))
    return {"refs": refs, "got": {k: v.numpy() for k, v in got.items()}, "port": port,
            "left": left, "right": right}


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("key", OUTPUTS)
def test_sdnet_mini_eval_forward_matches_jax(mini, s2d, key):
    ref, got = mini["refs"][s2d][key], mini["got"][key]
    assert got.shape == ref.shape == SHAPE[:3] + ((1,) if key.startswith("disp") else (2,))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_sdnet_mini_duplicates_its_heads(mini):
    np.testing.assert_array_equal(mini["got"]["seg2"], mini["got"]["seg1"])
    np.testing.assert_array_equal(mini["got"]["disp2"], mini["got"]["disp1"])


def test_sdnet_mini_patch_follows_the_corr_type(mini):
    port = mini["port"]
    assert port.corrConv2d.conv.in_channels == port.patch[0] * port.patch[1]
    assert port.normalize == (port.patch == (17, 17))


def test_sdnet_mini_train_mode_forward_per_view_batch_norm(mini):
    out = check_per_view_batch_norm(mini["port"], mini["left"], mini["right"], "cdu4.c1.bn")
    for k in OUTPUTS:
        assert torch.isfinite(out[k]).all() and out[k].shape == mini["got"][k].shape
    assert torch.equal(out["seg2"], out["seg1"]) and torch.equal(out["disp2"], out["disp1"])


def test_sdnet_mini_edges_build():
    """-edges, which raised before the edge inputs were ported, builds: the
    image conv takes the edge channel, the trunk the first three channels
    (parity with the JAX model: test_torch_edge_inputs.py)."""
    cfg = PMTConfig()
    cfg.model.net = "sdnet_mini"
    cfg.model.edges = True
    with reduced_depth():
        model = tmodels.get_network(cfg, device="cpu")
    assert model.conv2d_ba.conv.in_channels == 4
    assert model.features.backbone.conv0.in_channels == 3
