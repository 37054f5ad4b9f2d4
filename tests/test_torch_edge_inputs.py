"""The edge inputs against the JAX package:

* ``-edges`` (a sobel edge map as each view's fourth channel) on the
  flagship, ``sdnet_mini``, ``sdnetv2`` and ``sdnet``, eval forward at
  1x64x128, trunks at ``reduced_depth`` (``torch_port.compare_net``), within
  1e-3 * max|jax|; ``sdnet``'s trunk takes all four channels, as the JAX
  ``DSNet`` hands it ``input_a`` whole, the others' the first three;
* the model inputs the train and eval steps assemble (``-edges``, the edge
  nets' ``left_e``, JAX ``_model_inputs``), within 1e-6 relative;
* ``balanced_edge_bce`` and ``make_losses_fn`` of the ``edgeOut`` output
  type, within 1e-6 relative;
* ``sobel_edges`` (port ``ops/edges.py``, which ``data/datasets.py`` now
  imports), equal to the JAX package's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import compare_net, net_configs, torch_threads, worst_output  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import datasets as tdatasets
from pmt_learning_for_semantic_segmentation_and_disparity_torch.losses import balanced_edge_bce
from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import edges as tedges
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_losses_fn
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import step as tstep
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import edge as jedge
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops import edges as jedges
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training import step as jstep

REL, LOSS_REL = 1e-3, 1e-6
SHAPE = (1, 64, 128)
NETS = [("sdnet_mini_ext", "1dcorr"), ("sdnet_mini", "1dcorr"), ("sdnetv2", "2dcorr"),
        ("sdnet", "2dcorr")]


def batch(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, SHAPE)
    return {"left": rng.standard_normal(SHAPE + (3,), dtype=np.float32),
            "right": rng.standard_normal(SHAPE + (3,), dtype=np.float32),
            "edges": (rng.random(SHAPE + (1,)) > 0.7).astype(np.float32),
            "seg": np.eye(2, dtype=np.float32)[labels],
            "disp": rng.random(SHAPE + (1,), dtype=np.float32)}


@functools.lru_cache(maxsize=None)
def compared(net, corr_type):
    b = batch()
    left, right = (np.concatenate([b[k], b["edges"]], axis=-1) for k in ("left", "right"))
    return compare_net(net, left, right, corr_type=corr_type, edges=True)


@pytest.mark.parametrize("net,corr_type", NETS)
def test_edges_input_matches_jax(net, corr_type):
    ref, got, port = compared(net, corr_type)
    worst, key = worst_output(ref, got)
    assert worst <= REL, (key, worst)
    trunk_in = port.features.backbone.conv0.in_channels
    assert trunk_in == (4 if net == "sdnet" else 3)


def test_model_inputs_match_jax():
    """``-edges`` on an edge net: both views carry the edge channel, and
    ``left_e`` is the left image's gradient magnitude, not normalized."""
    b = batch(1)
    jcfg, cfg = net_configs("sdnet_mini_ext_small_edge", edges=True)
    assert cfg.model.output_type == jcfg.model.output_type == "edgeOut"
    jleft, jright, jkw = jstep._model_inputs(jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    left, right = tstep._model_images(cfg, tb, torch.device("cpu"))
    kw = tstep._model_kwargs(cfg, tb, torch.device("cpu"), bf16=False)
    assert set(kw) == set(jkw) == {"left_e"}
    for got, ref in ((left, jleft), (right, jright), (kw["left_e"], jkw["left_e"])):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= LOSS_REL * np.abs(ref).max()


def test_balanced_edge_bce_matches_jax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2,) + SHAPE[1:] + (1,))).astype(np.float32)
    edges = (rng.random(logits.shape) > 0.8).astype(np.float32)
    edges[0, :2] = 0.5  # neither edge nor background: weight 0
    ref = float(jedge.balanced_edge_bce(jnp.asarray(logits), jnp.asarray(edges)))
    got = balanced_edge_bce(torch.from_numpy(logits), torch.from_numpy(edges)).item()
    assert got == pytest.approx(ref, rel=LOSS_REL)


def test_make_losses_fn_edge_out_matches_jax():
    """The edge nets' loss: head 1's cross entropy (single head) plus the
    disparity stack plus ``balanced_edge_bce`` of the edge head."""
    rng = np.random.default_rng(3)
    b = batch(3)
    out = {k: (2 * rng.standard_normal(SHAPE + (c,))).astype(np.float32)
           for k, c in (("seg1", 2), ("seg2", 2), ("disp1", 1), ("disp2", 1), ("edge", 1))}
    jcfg, cfg = net_configs("sdnet_mini_ext_small_edge")
    for c in (jcfg, cfg):
        c.loss.losses = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")
    ref_loss, ref_logs = jstep.make_losses_fn(jcfg)(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0))
    losses = make_losses_fn(cfg)
    tout, tb = {k: torch.from_numpy(v) for k, v in out.items()}, {k: torch.from_numpy(v) for k, v in b.items()}
    loss, logs = losses(tout, tb)
    assert set(logs) == set(ref_logs)
    for k, v in logs.items():
        assert v.item() == pytest.approx(float(ref_logs[k]), rel=LOSS_REL), k
    no_edge = losses({k: v for k, v in tout.items() if k != "edge"}, tb)[0]
    assert (loss - no_edge).item() == pytest.approx(
        balanced_edge_bce(tout["edge"], tb["edges"]).item(), rel=1e-5)


def test_sobel_edges_moved_to_ops_and_matches_jax():
    gray = np.random.default_rng(4).integers(0, 4, (37, 53)).astype(np.float32)
    assert tdatasets.sobel_edges is tedges.sobel_edges
    np.testing.assert_array_equal(tedges.sobel_edges(gray), jedges.sobel_edges(gray))
