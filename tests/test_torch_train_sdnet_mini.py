"""Two float64 train steps of ``sdnet_mini`` (MiniDSNet, 1dcorr) against the
JAX package's ``make_train_step`` under ``jax.enable_x64``, from the same
weights and batch (``torch_port.float64_steps``): CE + Lovász + OHEM
(``FLOAT64_STACK``, the bench stack less MultiTversky, which both packages
compute in fp32), Adam, at 1x64x128 with the trunk at block config (2, 2, 2,
2); the full-depth step runs on the card in ``chip_smoke.py``.

Bounds as for the flagship (``test_torch_train_step.py``): both losses and
every BatchNorm running statistic within 1e-9 (relative), every gradient
tensor within 1e-6 * max|ref|. Its output type ``smallOutPair`` is single-
head: the loss is head 1's and the disparity's. The images are 64 pixels
high, the least at which the JAX package's 2-D correlation VJP takes the 1/8
map (a side below the patch radius 8 makes its pad widths negative). One net
a file, so that the suite's workers take them side by side.
"""
import numpy as np
import pytest
from torch_port import float64_steps, torch_threads, worst_relative  # noqa: F401


@pytest.fixture(scope="module")
def run():
    return float64_steps("sdnet_mini", "1dcorr")


@pytest.mark.parametrize("step", [0, 1])
def test_loss_matches_jax_in_float64(run, step):
    ref, got = run["jax_loss"][step], run["loss64"][step]
    assert np.isfinite(got) and abs(got - ref) <= 1e-9 * abs(ref), (got, ref)


def test_step0_gradients_match_jax_in_float64(run):
    worst = worst_relative(run["grads64"], run["jax_grads"])
    assert worst[0] <= 1e-6, worst


def test_step0_bn_running_stats_match_jax_in_float64(run):
    worst = worst_relative(run["stats64"], run["jax_stats"])
    assert worst[0] <= 1e-9, worst
