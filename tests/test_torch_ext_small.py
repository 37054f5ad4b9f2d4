"""The Ext_small nets and ``sdnet_mini_ext_dlab`` against the JAX models,
eval forward at 1x64x128, fp32 on the CPU, trunks at ``reduced_depth``
(``torch_port.compare_net``; the dlab net's ResNet-101 at ``layers=(1, 1,
1, 3)``):

* ``sdnet_mini_ext_small`` (v0) on densenet121, and on resnet50 at aspp 2
  (``aspp_4`` over tap 4, the second, unnormalized corr1d over the two
  views' ASPP);
* ``sdnet_mini_ext_small_edge`` (the skips from the left image's gradient
  magnitude ``left_e``, a keyword input) and ``_edgev2``: ``edge`` is head 1,
  ``seg1`` head 2;
* ``sdnet_mini_ext_dlab`` with 1dcorr, and with 2dcorr, ``no_dec1``,
  convDeconvOut 2 and HANet.

Bound: max|port - jax| <= 1e-3 * max|jax| per output. Train mode runs each
net's trunk once per view."""
import functools

import numpy as np
import pytest
import torch
from torch_port import check_per_view_batch_norm, compare_net, torch_threads, worst_output  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.hanet import (
    build_pos_grid as torch_pos_grid,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models.hanet import (
    build_pos_grid as jax_pos_grid,
)

REL = 1e-3
SHAPE = (1, 64, 128, 3)
CASES = {
    "v0": ("sdnet_mini_ext_small", {}),
    "v0_resnet50_aspp2": ("sdnet_mini_ext_small", {"backbone": "resnet50", "aspp": 2}),
    "edge": ("sdnet_mini_ext_small_edge", {}),
    "edgev2": ("sdnet_mini_ext_small_edgev2", {}),
    "dlab": ("sdnet_mini_ext_dlab", {}),
    "dlab_2dcorr_no_dec1_cdo2_hanet": ("sdnet_mini_ext_dlab", {
        "corr_type": "2dcorr", "ablation": ("no_dec1",), "conv_deconv_out": 2, "hanet": True}),
}


def inputs():
    rng = np.random.default_rng(0)
    left, right = (rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))
    left_e = rng.random(SHAPE, dtype=np.float32)  # a gradient magnitude is >= 0
    return left, right, left_e


def keyword_inputs(name):
    _, _, left_e = inputs()
    net, options = CASES[name]
    if net.endswith(("_edge", "_edgev2")):
        return {"left_e": left_e}, {"left_e": torch.from_numpy(left_e)}
    if options.get("hanet"):
        return {"pos": jax_pos_grid(*SHAPE[1:3])}, {"pos": torch_pos_grid(*SHAPE[1:3])}
    return {}, {}


@functools.lru_cache(maxsize=None)
def compared(name):
    net, options = CASES[name]
    left, right, _ = inputs()
    jax_kw, torch_kw = keyword_inputs(name)
    return compare_net(net, left, right, jax_kw, torch_kw, **options)


@pytest.mark.parametrize("name", sorted(CASES))
def test_net_matches_jax(name):
    ref, got, _ = compared(name)
    worst, key = worst_output(ref, got)
    assert worst <= REL, (key, worst)
    edge = name.startswith("edge")
    assert ("edge" in got) == edge
    if edge:
        assert got["edge"].shape == SHAPE[:3] + (1,)


@pytest.mark.parametrize("name,head_bn", [("edge", "rcu4.c1.bn"), ("dlab", "cdu4.c1.bn")])
def test_train_mode_runs_the_trunk_per_view(name, head_bn):
    _, got, port = compared(name)
    left, right, _ = inputs()
    out = check_per_view_batch_norm(port, left, right, head_bn, **keyword_inputs(name)[1])
    for k, v in got.items():
        assert tuple(out[k].shape) == v.shape and torch.isfinite(out[k]).all()
