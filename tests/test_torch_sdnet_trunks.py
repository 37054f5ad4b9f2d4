"""The flagship (``sdnet_mini_ext``) on the zoo's other trunks against the
JAX model: resnet50 (output stride 16, so ``aspp_4`` over both views' tap
4), efficientnet-b2, mobilenet and dn161, eval forward at 1x64x128, fp32 on
the CPU, trunks at ``reduced_depth`` (``torch_port.compare_net``). Bound:
max|port - jax| <= 1e-3 * max|jax| per output. Train mode runs each trunk
once per view, left then right, and ResNet's ``aspp_4`` too (its BatchNorms
move twice)."""
import functools

import numpy as np
import pytest
from torch_port import check_per_view_batch_norm, compare_net, torch_threads, worst_output  # noqa: F401

REL = 1e-3
SHAPE = (1, 64, 128, 3)
TRUNKS = ["resnet50", "efficientnet-b2", "mobilenet", "dn161"]


def images():
    rng = np.random.default_rng(0)
    return rng.standard_normal(SHAPE, dtype=np.float32), rng.standard_normal(SHAPE, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def compared(backbone):
    return compare_net("sdnet_mini_ext", *images(), backbone=backbone)


@pytest.mark.parametrize("backbone", TRUNKS)
def test_flagship_on_trunk_matches_jax(backbone):
    ref, got, port = compared(backbone)
    worst, key = worst_output(ref, got)
    assert worst <= REL, (key, worst)
    assert tuple(ref["seg1"].shape) == SHAPE[:3] + (2,)
    assert hasattr(port, "aspp_4") == backbone.startswith("resnet")


def test_resnet_flagship_runs_trunk_and_aspp_4_per_view():
    _, got, port = compared("resnet50")
    left, right = images()
    out = check_per_view_batch_norm(port, left, right, "cdu4.c1.bn", per_view_bn=("aspp_4.gp_bn",))
    for k, v in got.items():
        assert tuple(out[k].shape) == v.shape
