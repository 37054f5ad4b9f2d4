"""The port's building blocks against the flax modules of the JAX package,
with the same randomised variables (BatchNorm statistics included) carried
across by ``load_jax_variables``; fp32 on the CPU."""
import jax
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import blocks as tb
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet as td
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.jax_weights import (
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import blocks as jb
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import densenet as jd

# max |port - jax| <= REL * max |jax| (fp32, summation order only)
REL = 1e-5


def randomized_variables(jax_module, x, seed):
    """flax init, then every leaf replaced by numpy noise (positive var)."""
    rng = np.random.default_rng(seed)
    v = jax_module.init(jax.random.PRNGKey(seed), x)

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


@pytest.mark.parametrize("kernel", [3, 5])
def test_deconvbn(kernel):
    check(jb.DeconvBN(6, kernel, relu=True), tb.DeconvBN(4, 6, kernel, relu=True), _x(4))


@pytest.mark.parametrize("kernel", [3, 5])
def test_convout(kernel):
    check(jb.ConvOut(2, kernel), tb.ConvOut(8, 2, kernel), _x(8))


@pytest.mark.parametrize("kernel,last_layer", [(3, True), (3, False), (5, False)])
def test_conv2downup(kernel, last_layer):
    check(jb.Conv2DownUp(8, kernel, last_layer=last_layer),
          tb.Conv2DownUp(6, 8, kernel, last_layer=last_layer), _x(6))


def test_densenet_taps():
    """A narrow DenseNet: every tap (pre-pool transitions, conv0 before norm0,
    relu(norm5)) against the flax trunk."""
    jm = jd.DenseNetFeatures((2, 3, 2, 2), 8, 16)
    tm = td.DenseNetFeatures((2, 3, 2, 2), 8, 16)
    x = _x(3, hw=(64, 96))
    v = randomized_variables(jm, x, 1)
    refs = [np.asarray(t) for t in jm.apply(v, x)]
    load_jax_variables(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        taps = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tm.tap_channels == tuple(r.shape[-1] for r in refs)
    for got, ref in zip(taps, refs):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
