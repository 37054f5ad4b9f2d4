"""The port's EncoderDecoderNet (``models/encdec.py``) against the JAX
package's, on the CPU, from the port's seeded weights with every leaf made
non-zero (``torch_port.nonzero_leaves``: the attention's zero-initialised
``W`` too, so the ObjectContext path adds something), carried to flax by
``variables_from_port`` and back by ``load_jax_variables``:

* the eval forward of each decoder type at 1x64x64, ``num_filters`` 4, 5
  labels: ``unet_scse`` on resnet50 (bottleneck blocks), ``unet_seibn`` and
  ``unet_oc`` on resnet18 (basic blocks, identity layer-1 skip), within
  1e-3 * max|ref| (read: 1e-6 to 3e-6);
* the train-mode forward (batch statistics) and every running statistic
  of ``unet_scse`` and ``unet_seibn``, in float64 (the JAX package under
  ``jax.enable_x64``, a float64 copy of the port): within 1e-4 of max|ref|
  and of each statistic's layer scale (``torch_port._stat_error``; read:
  5e-12). In fp32 the resnet50 encoder's train mode is ill-conditioned at
  64x64: layer 4 normalises 2x2 maps by their own statistics, and the port
  in fp32 reads 9.6e-4 * max|ref| from the port in float64 (the JAX package
  in fp32 2.0e-3);
* ``SameConvTranspose2d`` at kernel 4, stride 2 with a bias against flax's
  ``ConvTranspose(padding="SAME")`` within 1e-6 * max|ref|;
* a square ``SELayer`` (reduction 1: its Dense kernels fit the Linear
  weights untransposed too) against flax's on values, within 1e-6;
* ``InstanceNorm`` against flax's ``LayerNorm(reduction_axes=(1, 2))``,
  on a 16x16 map and on the 1x1 map the center decoder meets at 64x64,
  within 1e-5 * max|ref| (read at 16x16: 6.3e-7; torch's two-pass
  ``instance_norm`` 7.1e-7; the sums' order differs from XLA's).

At 64x64, e5 is 2x2 and pool5 1x1 (it floors odd sizes: keep the inputs at
multiples of 64).
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from torch_port import (  # noqa: F401
    _stat_error,
    flax_stats_to_port,
    nonzero_leaves,
    port_stats,
    torch_threads,
    variables_from_port,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import (
    SameConvTranspose2d,
    init_parameters,
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import encdec as te
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import encdec as je

SHAPE = (1, 64, 64, 3)
CASES = {"unet_scse": "resnet50", "unet_seibn": "resnet18", "unet_oc": "resnet18"}


def pair(dec_type, seed=0):
    """(JAX model, port model in eval mode, flax variables of its weights)."""
    port = te.EncoderDecoderNet(5, CASES[dec_type], dec_type, 4)
    nonzero_leaves(init_parameters(port, torch.Generator().manual_seed(seed)), seed + 1)
    model = je.EncoderDecoderNet(labels=5, enc_type=CASES[dec_type], dec_type=dec_type, num_filters=4)
    x = np.zeros(SHAPE, np.float32)
    variables = variables_from_port(port.eval(), lambda k, a: model.init({"params": k}, a, train=False),
                                    jax.random.PRNGKey(0), x)
    return model, port, variables


def image(seed=2):
    return np.random.default_rng(seed).standard_normal(SHAPE, dtype=np.float32)


@pytest.mark.parametrize("dec_type", sorted(CASES))
def test_eval_forward_matches_jax(dec_type):
    model, _, variables = pair(dec_type)
    x = image()
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)["seg1"])
    port = te.EncoderDecoderNet(5, CASES[dec_type], dec_type, 4).eval()
    load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        out = port(torch.from_numpy(x))
        if dec_type == "unet_oc":  # the attention path contributes
            w = port.dec1.oc.attn.W
            assert w.weight.abs().min() > 0
            kept = w.weight.clone()
            w.weight.zero_()
            assert not torch.equal(port(torch.from_numpy(x))["seg1"], out["seg1"])
            w.weight.copy_(kept)
    assert set(out) == {"seg1", "disp1", "seg2", "disp2"}
    assert out["disp1"] is out["seg2"] is out["disp2"] is None
    got = out["seg1"].numpy()
    assert got.shape == ref.shape == (1, 64, 64, 5)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("dec_type", ["unet_scse", "unet_seibn"])
def test_train_forward_and_running_stats_match_jax(dec_type):
    model, port, variables = pair(dec_type, seed=3)
    x = image(4).astype(np.float64)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref, updated = jax.jit(lambda v, a: model.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, x)
        ref = np.asarray(ref["seg1"])
        assert ref.dtype == np.float64
    port.double().train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))["seg1"].numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    ref_stats, got_stats = flax_stats_to_port(updated["batch_stats"]), port_stats(port)
    assert set(got_stats) == set(ref_stats)
    assert max(_stat_error(got_stats, ref_stats, n) for n in ref_stats) <= 1e-4


def test_same_conv_transpose_k4_s2_with_bias_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 9, 6), dtype=np.float32)
    flax_up = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME")
    params = {"kernel": rng.standard_normal((4, 4, 6, 5), dtype=np.float32),
              "bias": rng.standard_normal(5, dtype=np.float32)}
    ref = np.asarray(flax_up.apply({"params": params}, x))
    up = SameConvTranspose2d(6, 5, 4, 2, bias=True)
    load_jax_variables(up, params, {})
    with torch.no_grad():
        got = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 14, 18, 5)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_square_se_layer_matches_flax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 6, 8), dtype=np.float32)
    params = {"fc1": {"kernel": rng.standard_normal((8, 8), dtype=np.float32)},
              "fc2": {"kernel": rng.standard_normal((8, 8), dtype=np.float32)}}
    ref = np.asarray(je.SELayer(reduction=1).apply({"params": params}, x))
    se = te.SELayer(8, reduction=1)
    load_jax_variables(se, params, {})
    with torch.no_grad():
        got = se(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("hw", [(16, 16), (1, 1)])
def test_instance_norm_matches_flax_layer_norm(hw):
    rng = np.random.default_rng(7)
    x = (3 + 2 * rng.standard_normal((2,) + hw + (6,))).astype(np.float32)
    params = {"scale": rng.standard_normal(6, dtype=np.float32),
              "bias": rng.standard_normal(6, dtype=np.float32)}
    norm = fnn.LayerNorm(use_scale=True, use_bias=True, epsilon=1e-5, reduction_axes=(1, 2),
                         feature_axes=-1)
    ref = np.asarray(norm.apply({"params": params}, x))
    inorm = te.InstanceNorm(6, eps=1e-5, affine=True)
    load_jax_variables(inorm, params, {})
    with torch.no_grad():
        got = inorm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
