"""``load_jax_variables``: every flax leaf fills exactly one port tensor,
every port parameter and running statistic is filled, and a leftover, a
missing leaf or a wrong shape raises."""
import copy

import jax
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import blocks as tb
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.jax_weights import (
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import blocks as jb


@pytest.fixture(scope="module")
def conv2downup():
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 4), dtype=np.float32)
    v = jb.Conv2DownUp(6, 3).init(jax.random.PRNGKey(0), x)
    v = jax.tree_util.tree_map(np.asarray, v)
    return v["params"], v["batch_stats"]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_every_leaf_fills_one_port_tensor(conv2downup):
    params, stats = conv2downup
    port = tb.Conv2DownUp(4, 6, 3)
    targets = [n for n in port.state_dict() if not n.endswith("num_batches_tracked")]
    for n in targets:
        port.state_dict()[n].fill_(float("nan"))
    load_jax_variables(port, params, stats)
    assert len(targets) == len(_leaves(params)) + len(_leaves(stats))
    assert all(torch.isfinite(port.state_dict()[n]).all() for n in targets)
    np.testing.assert_array_equal(port.c1.conv.weight.detach().numpy(),
                                  params["c1"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.d3.bn.running_var.numpy(), stats["d3"]["bn"]["var"])


def test_leftover_leaf_raises(conv2downup):
    params, stats = copy.deepcopy(conv2downup)
    params["c9"] = {"conv": {"kernel": np.zeros((3, 3, 6, 6), np.float32)}}
    with pytest.raises(KeyError, match="c9"):
        load_jax_variables(tb.Conv2DownUp(4, 6, 3), params, stats)


def test_unknown_leaf_name_raises(conv2downup):
    params, stats = copy.deepcopy(conv2downup)
    params["c1"]["conv"]["weights"] = params["c1"]["conv"].pop("kernel")
    with pytest.raises(KeyError, match="weights"):
        load_jax_variables(tb.Conv2DownUp(4, 6, 3), params, stats)


def test_missing_leaf_raises(conv2downup):
    params, stats = copy.deepcopy(conv2downup)
    del stats["d4"]["bn"]["mean"]
    with pytest.raises(KeyError, match="d4.bn.running_mean"):
        load_jax_variables(tb.Conv2DownUp(4, 6, 3), params, stats)


def test_wrong_shape_raises(conv2downup):
    params, stats = conv2downup
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(tb.Conv2DownUp(5, 6, 3), params, stats)  # c1 takes 5 channels


def test_port_tree_without_counterpart_raises(conv2downup):
    params, stats = conv2downup
    with pytest.raises(KeyError, match="d5"):
        load_jax_variables(tb.Conv2DownUp(4, 6, 3, last_layer=False), params, stats)
