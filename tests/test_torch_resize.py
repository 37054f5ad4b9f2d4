"""The port's resize ops (NCHW) against the JAX package's (NHWC), 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import resize as tr
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops import resize as jr

TOL = 1e-6
# Bilinear at a non-integer ratio: torch computes the fp32 source coordinate
# as (dst + 0.5) * (in / out) - 0.5, jax.image.resize as (dst + 0.5) / (out / in)
# - 0.5; the two roundings differ by an ulp of the coordinate (~2e-6 at
# 20 px), so there the bound is the 1e-5 that tests/test_ops.py holds the
# JAX op to against torch itself.
TOL_BILINEAR_NONINT = 1e-5


def _x(seed, shape=(2, 12, 20, 3)):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _port(fn, x, *args):
    out = fn(torch.from_numpy(x).permute(0, 3, 1, 2), *args)
    return out.permute(0, 2, 3, 1).numpy()


# integer up/down ratios, non-integer ratios, mixed, identity
SIZES = [(24, 40), (48, 160), (6, 10), (3, 5), (7, 13), (17, 33), (30, 50), (12, 20), (5, 45)]


@pytest.mark.parametrize("size", SIZES)
def test_resize_nearest(size):
    x = _x(0)
    np.testing.assert_allclose(_port(tr.resize_nearest, x, size),
                               np.asarray(jr.resize_nearest(jnp.asarray(x), size)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("size", SIZES)
def test_resize_bilinear(size):
    x = _x(1)
    h, w = x.shape[1:3]
    integer = all(a % b == 0 or b % a == 0 for a, b in ((h, size[0]), (w, size[1])))
    np.testing.assert_allclose(_port(tr.resize_bilinear, x, size),
                               np.asarray(jr.resize_bilinear(jnp.asarray(x), size)),
                               rtol=0, atol=TOL if integer else TOL_BILINEAR_NONINT)


@pytest.mark.parametrize("factor", [2, 8])
def test_upsample_nearest(factor):
    x = _x(2, (1, 4, 6, 5))
    np.testing.assert_allclose(_port(tr.upsample_nearest, x, factor),
                               np.asarray(jr.upsample_nearest(jnp.asarray(x), factor)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("window", [2, 3, 8])
def test_avg_pool(window):
    x = _x(3, (2, 17, 26, 4))  # not a multiple of the window: floor division
    np.testing.assert_allclose(_port(tr.avg_pool, x, window, window),
                               np.asarray(jr.avg_pool(jnp.asarray(x), window, window)),
                               rtol=0, atol=TOL)
