"""The plain ops of the warp nets and PSMNet, and their blocks, against the
JAX package, on the CPU:

* ``ops/warp.py:apply_disparity``: values and ``jax.vjp`` for the images
  and the offsets in float64 within 1e-12, with offsets that put
  coordinates exactly on 0 and W - 1 (where ``jnp.clip`` gives half the
  gradient) and beyond them (the right-edge rule samples those to zero);
  bf16 offsets take fp32 coordinates;
* ``ops/costvolume.py``: ``concat_cost_volume``, ``soft_argmin`` and
  ``upsampled_soft_argmin`` (a row chunk that divides H, and one that is H)
  in fp32 within 1e-5 * max|ref|;
* ``blocks.SameConvTranspose3d`` against flax's ``ConvTranspose`` with
  explicit (1, 2) padding within 1e-5 * max|ref|;
* ``PiramidNet2Warp`` (densenet121 at reduced depth) against the JAX pyramid,
  its nine outputs in eval and in train mode (with the running statistics,
  ``branch3_1``'s included) within 1e-4 * max|ref|.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import (  # noqa: F401
    flax_stats_to_port,
    port_stats,
    reduced_depth,
    torch_threads,
    variables_from_port,
)

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import (
    PiramidNet2Warp,
    init_parameters,
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.blocks import (
    SameConvTranspose3d,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import costvolume as tcv
from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import warp as twarp
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import pyramid as jpyramid
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops import costvolume as jcv
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops import warp as jwarp

B, H, W, C = 2, 3, 10, 4


def _offsets(rng):
    """Offsets whose coordinates x + offset land on integers, on 0 and W - 1
    exactly, between samples, and beyond both bounds."""
    off = rng.uniform(-3.0, 3.0, (B, H, W))
    x = np.arange(W)
    off[0, 0] = -x                 # every coordinate exactly 0
    off[0, 1] = (W - 1) - x        # every coordinate exactly W - 1
    off[1, 0] = np.round(off[1, 0])  # integer coordinates
    off[1, 1, :3] = [-5.0, 20.0, -0.0]
    return off


def test_apply_disparity_values_and_vjp_float64():
    rng = np.random.default_rng(0)
    images, off = rng.standard_normal((B, H, W, C)), _offsets(rng)
    g = rng.standard_normal((B, H, W, C))
    with jax.enable_x64(True):
        ref, vjp = jax.vjp(jwarp.apply_disparity, jnp.asarray(images), jnp.asarray(off[..., None]))
        d_img, d_off = (np.asarray(t) for t in vjp(jnp.asarray(g)))
        ref = np.asarray(ref)
    ti = torch.from_numpy(images).requires_grad_()
    to = torch.from_numpy(off[..., None]).requires_grad_()
    got = twarp.apply_disparity(ti, to)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ti.grad.numpy(), d_img, rtol=0, atol=1e-12)
    np.testing.assert_allclose(to.grad.numpy(), d_off, rtol=0, atol=1e-12)
    # the right-edge rule: a coordinate clamped to W - 1 samples zero
    assert np.abs(got.detach().numpy()[0, 1]).max() == 0.0
    # the half gradient at a bound: coordinates exactly on 0 get half the
    # offset gradient that the interior slope gives
    interior = (images[0, 0, 1] - images[0, 0, 0]) * g[0, 0, 0]
    assert to.grad[0, 0, 0, 0].item() == pytest.approx(0.5 * interior.sum(), abs=1e-12)


def test_apply_disparity_bf16_offsets_take_fp32_coordinates():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (rng.uniform(-2.0, 2.0, (B, H, W)) + 0.25).astype(np.float32)
    off_bf16 = torch.from_numpy(off).to(torch.bfloat16)
    ref = np.asarray(jwarp.apply_disparity(jnp.asarray(images), jnp.asarray(off_bf16.float().numpy(),
                                                                            jnp.bfloat16)))
    got = twarp.apply_disparity(torch.from_numpy(images), off_bf16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def test_concat_cost_volume_and_soft_argmin():
    rng = np.random.default_rng(2)
    ref_f, tgt_f = (rng.standard_normal((2, 5, 12, 6)).astype(np.float32) for _ in range(2))
    want = np.asarray(jcv.concat_cost_volume(jnp.asarray(ref_f), jnp.asarray(tgt_f), 7))
    to_nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    got = tcv.concat_cost_volume(to_nchw(ref_f), to_nchw(tgt_f), 7)
    assert got.shape == (2, 12, 7, 5, 12) and got.is_contiguous(memory_format=torch.channels_last_3d)
    assert _rel(got.permute(0, 2, 3, 4, 1).numpy(), want) <= 1e-5
    cost = rng.standard_normal((2, 9, 5, 12)).astype(np.float32) * 3
    assert _rel(tcv.soft_argmin(torch.from_numpy(cost), 9).numpy(),
                jcv.soft_argmin(jnp.asarray(cost), 9)) <= 1e-5


@pytest.mark.parametrize("chunk", [16, 48])
def test_upsampled_soft_argmin(chunk):
    """(B, D/4, H/4, W/4) = (2, 6, 12, 10) to D = 24 and 48 x 40: a chunk of
    16 rows divides H, one of 48 is H."""
    cost = np.random.default_rng(3).standard_normal((2, 6, 12, 10)).astype(np.float32) * 4
    want = jcv.upsampled_soft_argmin(jnp.asarray(cost), 24, (48, 40), chunk=chunk)
    got = tcv.upsampled_soft_argmin(torch.from_numpy(cost), 24, (48, 40), chunk=chunk)
    assert got.shape == (2, 48, 40)
    assert _rel(got.numpy(), want) <= 1e-5


def test_same_conv_transpose3d_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 3, 5, 6, 8)).astype(np.float32)  # NDHWC, odd and even sizes
    port = init_parameters(SameConvTranspose3d(8, 5), torch.Generator().manual_seed(0))
    layer = nn.ConvTranspose(5, (3, 3, 3), strides=(2, 2, 2), padding=((1, 2),) * 3, use_bias=False)
    kernel = port.weight.detach().numpy().transpose(2, 3, 4, 1, 0)
    want = np.asarray(layer.apply({"params": {"kernel": kernel}}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (1, 6, 10, 12, 5)
    assert _rel(got, want) <= 1e-5


def test_piramidnet2_warp_matches_jax():
    """Eval and train mode in one compiled reference."""
    x = np.random.default_rng(5).standard_normal((1, 64, 128, 3)).astype(np.float32)
    with reduced_depth():
        jax_pyr = jpyramid.PiramidNet2Warp()
        port = init_parameters(PiramidNet2Warp(), torch.Generator().manual_seed(0)).eval()
        variables = variables_from_port(port, lambda k, a: jax_pyr.init({"params": k}, a, train=False),
                                        jax.random.PRNGKey(0), x)
        refs = jax.jit(lambda v, a: (jax_pyr.apply(v, a, train=False),
                                     jax_pyr.apply(v, a, train=True, mutable=["batch_stats"])))(
            variables, x)
    ref_eval, (ref_train, upd) = refs
    load_jax_variables(port, variables["params"], variables["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got_eval = port(xt)
        got_train = port.train()(xt)
    assert tuple(port.out_channels) == tuple(np.shape(t)[-1] for t in ref_eval)
    for got, ref in ((got_eval, ref_eval), (got_train, ref_train)):
        assert len(got) == len(ref) == 9
        for g, r in zip(got, ref):
            assert _rel(g.permute(0, 2, 3, 1).numpy(), r) <= 1e-4
    # in train mode every BatchNorm moved once, branch3_1's too
    want, mine = flax_stats_to_port(upd["batch_stats"]), port_stats(port)
    assert set(want) == set(mine) and "branch3_1.bn.running_var" in mine
    for k in want:
        assert np.abs(mine[k] - want[k]).max() <= 1e-4 * max(np.abs(want[k]).max(), 1.0), k
