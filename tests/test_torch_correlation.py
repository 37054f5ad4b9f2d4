"""The port's correlation (plain PyTorch path) against the JAX package's
``correlation_lax`` and its Pallas kernel in interpret mode, fp32, abs 1e-5.
The CUDA kernel itself is checked on the card by ``chip_smoke.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages' ops/__init__ re-export the function ``correlation`` over the module name
tcorr = importlib.import_module(
    "pmt_learning_for_semantic_segmentation_and_disparity_torch.ops.correlation")
jcorr = importlib.import_module(
    "pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops.correlation")

ATOL = 1e-5


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("shape,pw", [
    ((2, 8, 16, 12), 17),
    ((1, 5, 9, 4), 5),
    ((2, 3, 7, 6), 17),   # W < pw
    ((1, 4, 40, 35), 17),
])
def test_corr1d_plain_matches_lax(shape, pw):
    f1, f2 = _pair(0, shape)
    ref = np.asarray(jcorr.correlation_lax(jnp.asarray(f1), jnp.asarray(f2), (1, pw)))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), (1, pw)).numpy()
    assert got.shape == ref.shape == shape[:3] + (pw,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 16, 12), (1, 4, 10, 20)])
def test_corr1d_plain_matches_pallas_interpret(shape):
    f1, f2 = _pair(1, shape)
    ref = np.asarray(jcorr.correlation1d_pallas(jnp.asarray(f1), jnp.asarray(f2), 17,
                                                interpret=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), (1, 17)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch", [(5, 5), (3, 7)])
def test_corr2d_plain_normalized_matches_lax(patch):
    f1, f2 = _pair(2, (1, 6, 10, 8))
    ref = np.asarray(jcorr.correlation_lax(jnp.asarray(f1), jnp.asarray(f2), patch,
                                           normalize=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                                  normalize=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch,normalize", [((1, 17), False), ((1, 17), True), ((5, 5), True)])
def test_dispatcher_on_cpu_matches_jax_dispatcher(patch, normalize):
    f1, f2 = _pair(3, (1, 4, 12, 16))
    ref = np.asarray(jcorr.correlation(jnp.asarray(f1), jnp.asarray(f2), patch,
                                       normalize=normalize))
    got = tcorr.correlation(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                            normalize=normalize).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_dispatcher_sends_2d_off_the_cpu_to_the_roadmap():
    # a tensor that is not on the CPU takes the kernel route; the 2-D kernel
    # is not ported, so it must raise rather than fall back to the plain path
    f = torch.empty((1, 4, 12, 16), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcorr.correlation(f, f, (5, 5))


def test_kernel_wrapper_rejects_cpu_tensors():
    f1, f2 = _pair(4, (1, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.correlation1d_cuda(torch.from_numpy(f1), torch.from_numpy(f2), 17)
    assert tcorr.correlation1d_cuda.launches == 0
