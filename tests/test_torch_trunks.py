"""The densenets and ResNets of the port's zoo against the JAX trunks at
reduced depth (``torch_port.check_trunk``): dn169, dn201 and dn161 (their
own growth and initial features at block config (2, 2, 2, 2)), resnet50 and
resnet101 (output stride 16, multi-grid layer 4) and the dlab net's
ResNet-101 (HANet's 3x3x3 stem at output stride 8) at ``layers=(1, 1, 1,
3)``: eval taps, train taps and running statistics within 1e-4 * max|jax|
(a running mean against its layer's scale, ``torch_port._stat_error``)."""
import pytest
from torch_port import DLAB_TRUNK, TRUNK_REL, check_trunk, torch_threads  # noqa: F401


@pytest.mark.parametrize("name", ["dn169", "dn201", "dn161", "resnet50", "resnet101", DLAB_TRUNK])
def test_trunk_matches_jax(name):
    worst = check_trunk(name)
    assert all(v <= TRUNK_REL for v in worst.values()), worst
