"""The building blocks the zoo's trunks added to the port, against flax:

* ``load_jax_variables`` transposes a 2-D flax ``Dense`` kernel (in, out)
  into the ``nn.Linear`` weight (out, in): a square Dense loads and
  computes flax's function, and the untransposed load is shown to differ;
* ``init_parameters``: an ``nn.Linear`` gets flax ``Dense``'s lecun normal
  (truncated, variance 1/fan_in) and a zero bias; a grouped (depthwise)
  conv's fan-in is one group's, as flax's (k, k, C/groups, O) kernel gives
  it; a biased ``nn.Conv2d`` without an ``init_rule`` gets flax ``Conv``'s
  lecun normal and a zero bias;
* ``SameConv2d`` pads as flax's ``padding="SAME"`` at stride 2 (asymmetric
  on an even input: (0, 1) for 3x3, (1, 2) for 5x5), within 1e-5;
* ``batch_norm(c, eps=1e-3, momentum=0.99)``: EfficientNet's BatchNorm,
  the normalisation and the running update of flax's, within 1e-6.
"""
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from torch_port import flax_stats_to_port, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import (
    init_parameters,
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.blocks import (
    SameConv2d,
    batch_norm,
    conv2d,
    same_padding,
)

TRUNC_STD = 0.87962566103423978  # a standard normal truncated to [-2, 2]


def test_square_dense_loads_transposed():
    x = np.random.default_rng(0).standard_normal((3, 16), dtype=np.float32)
    dense = fnn.Dense(16, name="fc")
    params = dense.init(jax.random.PRNGKey(1), x)["params"]
    ref = np.asarray(dense.apply({"params": params}, x))

    port = nn.Module()
    port.fc = nn.Linear(16, 16)
    load_jax_variables(port, {"fc": params}, {})
    with torch.no_grad():
        got = port.fc(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        port.fc.weight.copy_(torch.from_numpy(np.array(params["kernel"])))  # untransposed
        wrong = port.fc(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - ref).max() > 0.1 * np.abs(ref).max()


def _std_and_bound(w: torch.Tensor, fan: int, scale: float = 1.0):
    std = math.sqrt(scale / fan)
    assert w.abs().max().item() <= 2 * std / TRUNC_STD * (1 + 1e-6)  # truncated at 2 sigma
    assert w.std().item() == pytest.approx(std, rel=0.05)


def test_init_parameters_linear_is_flax_dense_default():
    model = nn.Sequential(nn.Linear(256, 512))
    with torch.no_grad():
        model[0].bias.fill_(1.0)
    init_parameters(model, torch.Generator().manual_seed(0))
    _std_and_bound(model[0].weight, 256)
    assert torch.equal(model[0].bias, torch.zeros(512))
    # the flax init it mirrors draws with the same statistics
    kernel = fnn.Dense(512).init(jax.random.PRNGKey(0), jnp.zeros((1, 256)))["params"]["kernel"]
    assert float(jnp.std(kernel)) == pytest.approx(math.sqrt(1 / 256), rel=0.05)


def test_init_parameters_grouped_conv_takes_one_groups_fan_in():
    model = nn.Sequential(conv2d(96, 96, 5, groups=96, init="kaiming"),
                          SameConv2d(96, 96, 3, 2, groups=96, init="he_fan_out"))
    init_parameters(model, torch.Generator().manual_seed(0))
    _std_and_bound(model[0].weight, 5 * 5 * 1, 2.0)  # fan_in: 25 taps of one channel
    assert model[1].weight.std().item() == pytest.approx(math.sqrt(2 / (3 * 3 * 96)), rel=0.05)
    kernel = fnn.Conv(96, (5, 5), feature_group_count=96, kernel_init=fnn.initializers.kaiming_normal()
                      ).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 96)))["params"]["kernel"]
    assert kernel.shape == (5, 5, 1, 96)
    assert float(jnp.std(kernel)) == pytest.approx(math.sqrt(2 / 25), rel=0.05)


def test_init_parameters_biased_conv_is_flax_conv_default():
    model = nn.Sequential(nn.Conv2d(480, 120, 1))  # no init_rule: an SE conv
    with torch.no_grad():
        model[0].bias.fill_(1.0)
    init_parameters(model, torch.Generator().manual_seed(0))
    _std_and_bound(model[0].weight, 480)
    assert torch.equal(model[0].bias, torch.zeros(120))


@pytest.mark.parametrize("hw", [(64, 128), (63, 127)])
def test_same_conv2d_matches_flax_same_at_stride_2(hw):
    rng = np.random.default_rng(5)
    for kernel, groups in ((3, 1), (5, 24)):
        x = rng.standard_normal((2,) + hw + (24,), dtype=np.float32)
        conv = fnn.Conv(24, (kernel, kernel), strides=(2, 2), padding="SAME", use_bias=False,
                        feature_group_count=groups)
        params = conv.init(jax.random.PRNGKey(0), x)["params"]
        ref = np.asarray(conv.apply({"params": params}, x))
        port = SameConv2d(24, 24, kernel, 2, groups=groups)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.array(params["kernel"]).transpose(3, 2, 0, 1)))
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if hw[0] % 2 == 0:
        assert same_padding(hw[0], 3, 2) == (0, 1) and same_padding(hw[0], 5, 2) == (1, 2)


def test_efficientnet_batch_norm_matches_flax():
    rng = np.random.default_rng(6)
    x = (3 + 2 * rng.standard_normal((2, 5, 7, 16))).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = bn.init(jax.random.PRNGKey(0), x)
    ref, updated = bn.apply(variables, x, mutable=["batch_stats"])
    port = batch_norm(16, 1e-3, 0.99).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = flax_stats_to_port({"bn": updated["batch_stats"]})
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(port, name).numpy(), stats[f"bn.{name}"], rtol=1e-6,
                                   atol=1e-6)
    assert port.running_mean.max().item() == pytest.approx(0.01 * x.mean(axis=(0, 1, 2)).max(),
                                                           rel=1e-4)
