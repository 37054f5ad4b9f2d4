"""The port's building blocks against the flax modules of the JAX package,
with the same randomised variables (BatchNorm statistics included) carried
across by ``load_jax_variables``; fp32 on the CPU, a single block's flax
init and apply eagerly (cheaper on the CPU than a compile). Whole trunks
built from them: ``test_torch_blocks_trunks.py``."""
import flax.linen as nn
import jax
import numpy as np
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import blocks as tb
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.jax_weights import (
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import blocks as jb

# max |port - jax| <= REL * max |jax| (fp32, summation order only)
REL = 1e-5


def randomized_variables(jax_module, x, seed, jit=False):
    """flax init, then every leaf replaced by numpy noise (positive var)."""
    rng = np.random.default_rng(seed)
    init = jax.jit(jax_module.init) if jit else jax_module.init
    v = init(jax.random.PRNGKey(seed), x)

    def noise(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(noise, v[k]) for k in v}


def check(jax_module, port_module, x, seed=0):
    v = randomized_variables(jax_module, x, seed)
    ref = np.asarray(jax_module.apply(v, x))
    load_jax_variables(port_module, v["params"], v.get("batch_stats", {}))
    with torch.no_grad():
        got = port_module.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def _x(cin, seed=0, hw=(12, 18)):
    return np.random.default_rng(seed).standard_normal((2, *hw, cin), dtype=np.float32)


@pytest.mark.parametrize("kernel,dilation,batchnorm,relu", [
    (3, 1, True, False), (1, 1, False, True), (5, 2, True, True), (3, 1, False, False),
])
def test_convbn(kernel, dilation, batchnorm, relu):
    check(jb.ConvBN(7, kernel, dilation=dilation, batchnorm=batchnorm, relu=relu),
          tb.ConvBN(5, 7, kernel, dilation=dilation, batchnorm=batchnorm, relu=relu), _x(5))


@pytest.mark.parametrize("relu", [False, True])
def test_convbn_train_mode_matches_flax(relu):
    """Train-mode BatchNorm at 8 pixels a channel (2x2x2), where the biased
    and the unbiased batch variance differ by 8/7: the output, the input and
    parameter gradients for a random output gradient, and the new running
    mean and variance against flax's ``mutable=["batch_stats"]`` apply
    (momentum 0.9, biased variance). Bound 1e-5 * max|ref| (fp32)."""
    jm, tm = jb.ConvBN(6, 3, relu=relu), tb.ConvBN(5, 6, 3, relu=relu)
    x = _x(5, hw=(2, 2))
    v = randomized_variables(jm, x, 3)
    cot = np.random.default_rng(4).standard_normal((2, 2, 2, 6)).astype(np.float32)

    def fwd(params, x):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (ref, stats), pullback = jax.vjp(fwd, v["params"], x)
    g_params, g_x = pullback((cot, jax.tree_util.tree_map(np.zeros_like, stats)))
    load_jax_variables(tm, v["params"], v["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm.train()(xt)
    got.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))

    def close(a, b):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5 * np.abs(b).max()

    close(got.detach().permute(0, 2, 3, 1).numpy(), ref)
    close(xt.grad.permute(0, 2, 3, 1).numpy(), g_x)
    close(tm.conv.weight.grad.permute(2, 3, 1, 0).numpy(), g_params["conv"]["kernel"])
    close(tm.bn.weight.grad.numpy(), g_params["bn"]["scale"])
    close(tm.bn.bias.grad.numpy(), g_params["bn"]["bias"])
    close(tm.bn.running_mean.numpy(), stats["bn"]["mean"])
    close(tm.bn.running_var.numpy(), stats["bn"]["var"])
    # torch's own rule (unbiased variance) would be off by the 8/7 factor
    y = tm.conv(xt.detach())
    biased = y.var(dim=(0, 2, 3), unbiased=False).detach().numpy()
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               0.9 * v["batch_stats"]["bn"]["var"] + 0.1 * biased, rtol=1e-5)


@pytest.mark.parametrize("kernel", [3, 5])
def test_deconvbn(kernel):
    check(jb.DeconvBN(6, kernel, relu=True), tb.DeconvBN(4, 6, kernel, relu=True), _x(4))


# (cin, features, kernel, input hw); 32 -> 32 is square, so a kernel loaded
# in torch's ConvTranspose2d layout (I, O, kh, kw) would fit its shape and
# compute another function
STRIDE2_CASES = [(6, 4, 3, (4, 6)), (32, 32, 3, (5, 7)), (64, 32, 3, (6, 9)), (8, 6, 5, (5, 7))]


@pytest.mark.parametrize("cin,features,kernel,hw", STRIDE2_CASES)
def test_same_conv_transpose_matches_flax(cin, features, kernel, hw):
    """The bare stride-2 transposed conv against flax ``nn.ConvTranspose``
    with SAME padding and its own random init (outputs of order 1), abs 1e-5."""
    x = _x(cin, hw=hw)
    jm = nn.ConvTranspose(features, (kernel, kernel), strides=(2, 2), padding="SAME",
                          use_bias=False)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), x))
    ref = np.asarray(jm.apply(v, x))
    tm = tb.SameConvTranspose2d(cin, features, kernel, 2)
    load_jax_variables(tm, v["params"], {})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], features)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cin,features,kernel,hw", STRIDE2_CASES)
def test_deconvbn_stride2(cin, features, kernel, hw):
    check(jb.DeconvBN(features, kernel, stride=2, relu=True),
          tb.DeconvBN(cin, features, kernel, stride=2, relu=True), _x(cin, hw=hw))


def test_same_conv_transpose_init_fan_out_is_flax():
    """He-normal on fan-out kh*kw*O, as flax reads a ConvTranspose kernel."""
    tm = tb.SameConvTranspose2d(16, 64, 3, 2)
    tb.init_parameters(tm, torch.Generator().manual_seed(0))
    assert abs(tm.weight.std().item() / (2.0 / (9 * 64)) ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("kernel", [3, 5])
def test_convout(kernel):
    check(jb.ConvOut(2, kernel), tb.ConvOut(8, 2, kernel), _x(8))


@pytest.mark.parametrize("kernel,last_layer", [(3, True), (3, False), (5, False)])
def test_conv2downup(kernel, last_layer):
    check(jb.Conv2DownUp(8, kernel, last_layer=last_layer),
          tb.Conv2DownUp(6, 8, kernel, last_layer=last_layer), _x(6))
