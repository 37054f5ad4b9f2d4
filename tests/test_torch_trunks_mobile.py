"""EfficientNet-b2..b5 (one block a stage, their published widths) and
MobileNetV3-Large (whole) against the JAX trunks
(``torch_port.check_trunk``): eval taps, train taps and running
statistics within 1e-4 * max|jax| (a running mean against its layer's
scale, ``torch_port._stat_error``). EfficientNet's stride-2 depthwise convs
pad flax's SAME asymmetrically on the even input, and its BatchNorm moves
the running statistics by 0.01 a step."""
import pytest
from torch_port import TRUNK_REL, check_trunk, torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["efficientnet-b2", "efficientnet-b3", "efficientnet-b4",
                                  "efficientnet-b5", "mobilenet"])
def test_trunk_matches_jax(name):
    worst = check_trunk(name)
    assert all(v <= TRUNK_REL for v in worst.values()), worst
