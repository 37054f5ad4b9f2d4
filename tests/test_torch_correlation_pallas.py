"""The port's correlation (plain PyTorch path) against the JAX package's
Pallas kernels in interpret mode, fp32, abs 1e-5: corr1d's
(``correlation1d_pallas``) and corr2d's (``correlation2d_pallas``, with and
without the normalisation by C). A file of its own, apart from
``test_torch_correlation.py``: each interpreted kernel takes seconds, and
the suite's workers take files of few cases after its heavy ones."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

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


@pytest.mark.parametrize("shape", [(2, 8, 16, 12), (1, 4, 10, 20)])
def test_corr1d_plain_matches_pallas_interpret(shape):
    f1, f2 = _pair(1, shape)
    ref = np.asarray(jcorr.correlation1d_pallas(jnp.asarray(f1), jnp.asarray(f2), 17,
                                                interpret=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), (1, 17)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch,normalize", [
    ((17, 17), True), ((17, 17), False), ((5, 5), True), ((5, 5), False)])
@pytest.mark.parametrize("shape", [
    (1, 8, 12, 4),     # H, W < 17: the halo is larger than the map
    (2, 8, 20, 6),
])
def test_corr2d_plain_matches_pallas_interpret(shape, patch, normalize):
    f1, f2 = _pair(5, shape)
    ref = np.asarray(jcorr.correlation2d_pallas(jnp.asarray(f1), jnp.asarray(f2), patch,
                                                normalize=normalize, h_tile=4, interpret=True))
    got = tcorr.correlation_plain(torch.from_numpy(f1), torch.from_numpy(f2), patch,
                                  normalize=normalize).numpy()
    assert got.shape == ref.shape == shape[:3] + (patch[0] * patch[1],)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
