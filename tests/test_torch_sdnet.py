"""The port's flagship eval forward (sdnet_mini_ext, densenet121, aspp 0,
attention gates, with 1dcorr and with 2dcorr) against the JAX model at
1x64x128, fp32 on the CPU.

One set of variables per correlation type is shared by its cases: the port's
seeded weights as a flax tree (``torch_port.variables_from_port``), carried
back into the port with ``load_jax_variables``. The JAX model runs with
``s2d_heads`` on and off (the same variables fit both). Random-init outputs
reach ~2e4, so the bound is relative: max|port - jax| <= 1e-3 * max|jax| per
output. The flagship (1dcorr) runs at full depth; the 2dcorr variant with
the trunk at block config (2, 2, 2, 2) (``torch_port.reduced_depth``).
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
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    compute_metrics,
    make_forward_fn,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig

REL = 1e-3
# bf16 policy against the port's own fp32 forward, as ||bf16 - fp32|| /
# ||fp32||. bf16 rounding (8-bit mantissa) compounds over ~60 layers of a
# random-init net, and the attention gates of head 2 multiply large values:
# on this input the JAX package's own bf16 policy is off its fp32 forward by
# 0.009 (seg1), 0.17 (seg2) and 0.012 (disp1).
REL_L2_BF16 = {"seg1": 0.03, "seg2": 0.25, "disp1": 0.03}
SHAPE = (1, 64, 128, 3)
OUTPUTS = ("seg1", "seg2", "disp1")


def run_against_jax(corr_type):
    rng = np.random.default_rng(0)
    left = rng.standard_normal(SHAPE, dtype=np.float32)
    right = rng.standard_normal(SHAPE, dtype=np.float32)
    cfg = PMTConfig()
    cfg.model.corr_type = corr_type
    port = tmodels.get_network(cfg, device="cpu")
    refs = {}
    variables = None
    for s2d in (True, False):
        cfg = JaxConfig()
        cfg.model.corr_type = corr_type
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
    return {"left": left, "right": right, "refs": refs, "port": port,
            "got": {k: v.numpy() for k, v in got.items()}}


@pytest.fixture(scope="module")
def flagship():
    return run_against_jax("1dcorr")


@pytest.fixture(scope="module")
def flagship_2dcorr():
    with reduced_depth():
        return run_against_jax("2dcorr")


def check_against_jax(run, s2d, key):
    ref = run["refs"][s2d][key]
    got = run["got"][key]
    assert got.shape == ref.shape == SHAPE[:3] + ((1,) if key == "disp1" else (2,))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("key", OUTPUTS)
def test_flagship_eval_forward_matches_jax(flagship, s2d, key):
    check_against_jax(flagship, s2d, key)


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("key", OUTPUTS)
def test_flagship_2dcorr_eval_forward_matches_jax(flagship_2dcorr, s2d, key):
    assert flagship_2dcorr["port"].corrConv2d.conv.in_channels == 289
    check_against_jax(flagship_2dcorr, s2d, key)


def test_forward_fn_fp32_is_the_model(flagship):
    forward = make_forward_fn(PMTConfig(), flagship["port"], device="cpu")
    batch = {"left": torch.from_numpy(flagship["left"]),
             "right": torch.from_numpy(flagship["right"])}
    with torch.inference_mode():
        out = forward(batch)
    for k in OUTPUTS:
        np.testing.assert_array_equal(out[k].numpy(), flagship["got"][k])


def test_forward_fn_bf16_policy(flagship):
    cfg = PMTConfig()
    cfg.parallel.bf16 = True
    port = flagship["port"]
    forward = make_forward_fn(cfg, port, device="cpu")
    batch = {"left": torch.from_numpy(flagship["left"]),
             "right": torch.from_numpy(flagship["right"])}
    with torch.inference_mode():
        out = forward(batch)
    assert all(p.dtype == torch.float32 for p in port.parameters())  # master weights untouched
    for k in OUTPUTS:
        got, ref = out[k].numpy(), flagship["got"][k]
        assert out[k].dtype == torch.float32 and np.isfinite(got).all()
        assert np.linalg.norm(got - ref) <= REL_L2_BF16[k] * np.linalg.norm(ref)


def test_metrics_on_forward_outputs(flagship):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, SHAPE[:3])
    seg = np.eye(3, dtype=np.float32)[labels]
    disp = rng.uniform(0.1, 50.0, SHAPE[:3] + (1,)).astype(np.float32)
    batch = {"seg": torch.from_numpy(seg), "disp": torch.from_numpy(disp)}
    out = {k: torch.from_numpy(v) for k, v in flagship["got"].items()}
    m = compute_metrics(PMTConfig(), out, batch)
    assert float(m["conf1"].sum()) == float(m["conf2"].sum()) == labels.size
    assert all(np.isfinite(v.numpy()).all() for v in m.values())


def test_entry_points_need_a_card_unless_told_cpu(flagship):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.get_network(PMTConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_forward_fn(PMTConfig(), flagship["port"])


@pytest.mark.parametrize("field,value", [
    ("edges", True), ("backbone", "dn169"), ("backbone", "mobilenet"), ("backbone", "resnet50"),
])
def test_formerly_unported_options_build_and_serve(field, value):
    """The options that raised ``NotImplementedError`` before the zoo's
    trunks and the edge inputs were ported (-edges, trunks other than
    densenet121) now build at reduced depth and serve 1x32x64: finite
    outputs of the flagship's shapes (parity with the JAX model:
    test_torch_sdnet_trunks.py, test_torch_edge_inputs.py)."""
    cfg = PMTConfig()
    setattr(cfg.model, field, value)
    channels = 4 if cfg.model.edges else 3
    g = torch.Generator().manual_seed(0)
    left, right = (torch.randn(1, 32, 64, channels, generator=g) for _ in range(2))
    with reduced_depth():
        port = tmodels.get_network(cfg, device="cpu")
    assert port.conv2d_ba.conv.in_channels == channels
    with torch.inference_mode():
        out = port(left, right)
    assert all(torch.isfinite(out[k]).all() and out[k].shape[:3] == (1, 32, 64) for k in OUTPUTS)


@pytest.mark.parametrize("field,value", [
    ("aspp", 1), ("hanet", True), ("multaskloss", 1), ("conv_deconv_out", 1), ("use_att", False),
    ("ablation", ("no_dec1",)),
])
def test_ported_options_build_and_serve(field, value):
    """Each option alone builds at reduced depth and serves 1x32x64: finite
    outputs of the flagship's shapes (parity with the JAX model:
    test_torch_sdnet_options.py)."""
    cfg = PMTConfig()
    setattr(cfg.model, field, value)
    g = torch.Generator().manual_seed(0)
    left, right = torch.randn(1, 32, 64, 3, generator=g), torch.randn(1, 32, 64, 3, generator=g)
    with reduced_depth():
        port = tmodels.get_network(cfg, device="cpu")
    with torch.inference_mode():
        out = port(left, right)
    assert all(torch.isfinite(out[k]).all() and out[k].shape[:3] == (1, 32, 64) for k in OUTPUTS)


def test_train_mode_forward_per_view_batch_norm(flagship):
    """Train mode runs the trunk once per view, left then right
    (``torch_port.check_per_view_batch_norm``); a head's BatchNorm moves
    once."""
    out = check_per_view_batch_norm(flagship["port"], flagship["left"], flagship["right"],
                                    "cdu4.c1.bn")
    assert all(torch.isfinite(out[k]).all() and out[k].shape == flagship["got"][k].shape
               for k in OUTPUTS)


def test_same_seed_same_weights():
    # seeded inits compared at reduced depth (the initialisers do not depend on it)
    with reduced_depth():
        a = tmodels.get_network(PMTConfig(), device="cpu", seed=3)
        b = tmodels.get_network(PMTConfig(), device="cpu", seed=3)
        c = tmodels.get_network(PMTConfig(), device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["features.backbone.conv0.weight"], sc["features.backbone.conv0.weight"])
