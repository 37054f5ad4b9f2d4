"""The port's losses against the JAX package's: values and input gradients at
(2,16,32,C), fp32 on the CPU, inputs from numpy seeds.

Bounds: values within 1e-5 relative, input gradients within 1e-5 *
max|ref| (fp32 summation order; the Lovász cumulative sums over 1024 sorted
pixels are the longest chains). Lovász runs at C = 2 (the JAX package's
single-sort path) and C = 9; Tversky's gradient ignores the upstream factor
and forces alpha = 0.7, beta = 0.3 in both packages. ``make_losses_fn``
is held against the JAX package's for the output type of every ported net.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import losses as tl
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_losses_fn
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import dispatch as jdispatch
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import disp as jdisp
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import lovasz as jlovasz
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import ohem as johem
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import seg as jseg
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import tversky as jtversky
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training.step import (
    make_losses_fn as jax_make_losses_fn,
)

SHAPE = (2, 16, 32)
REL = 1e-5


def logits_and_labels(c, seed=0, ignore=None):
    rng = np.random.default_rng(seed)
    logits = (2 * rng.standard_normal(SHAPE + (c,))).astype(np.float32)
    labels = rng.integers(0, c, SHAPE)
    if ignore is not None:
        labels[rng.random(SHAPE) < 0.2] = ignore
    return logits, labels


def compare(jax_fn, torch_fn, x, *args):
    """Value and d/dx of jax_fn(x, *args) and torch_fn(x, *args)."""
    ref, ref_g = jax.value_and_grad(lambda a: jax_fn(a, *args))(jnp.asarray(x))
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    got = torch_fn(xt, *args)
    got.backward()
    ref, ref_g = float(ref), np.asarray(ref_g)
    assert abs(got.item() - ref) <= REL * abs(ref), (got.item(), ref)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, rtol=0, atol=REL * np.abs(ref_g).max())
    return got.item(), xt.grad.numpy()


def as_torch(fn):
    """fn of torch tensors, called with numpy label/mask arguments."""
    return lambda x, *args: fn(x, *(torch.from_numpy(np.asarray(a)) for a in args))


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy(weighted):
    logits, labels = logits_and_labels(9)
    gt = np.eye(9, dtype=np.float32)[labels]
    w = np.linspace(0.5, 2.0, 9).astype(np.float32) if weighted else None
    compare(lambda x, g: jseg.categorical_cross_entropy(jax.nn.log_softmax(x), g,
                                                        None if w is None else jnp.asarray(w)),
            lambda x, g: tl.categorical_cross_entropy(torch.log_softmax(x, -1), torch.from_numpy(g),
                                                      None if w is None else torch.from_numpy(w)),
            logits, gt)


def test_pick_class_and_class_weight_map():
    logits, labels = logits_and_labels(5)
    w = np.arange(1, 6, dtype=np.float32)
    np.testing.assert_array_equal(
        tl.pick_class(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jseg.pick_class(jnp.asarray(logits), jnp.asarray(labels))))
    np.testing.assert_array_equal(
        tl.class_weight_map(torch.from_numpy(w), torch.from_numpy(labels)).numpy(),
        np.asarray(jseg.class_weight_map(jnp.asarray(w), jnp.asarray(labels))))


@pytest.mark.parametrize("c,ignore", [(2, None), (9, None), (9, 19)])
def test_lovasz_softmax(c, ignore):
    logits, labels = logits_and_labels(c, seed=c, ignore=ignore)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    compare(lambda p, lab: jlovasz.lovasz_softmax(p, lab, ignore=ignore),
            as_torch(lambda p, lab: tl.lovasz_softmax(p, lab, ignore=ignore)), probs, labels)


def test_lovasz_c2_reads_the_foreground_probability_only():
    # the JAX package's C = 2 path sorts |fg1 - p1| once: no gradient reaches p0
    logits, labels = logits_and_labels(2, seed=3)
    probs = torch.from_numpy(logits).softmax(-1).requires_grad_()
    tl.lovasz_softmax(probs, torch.from_numpy(labels)).backward()
    assert not probs.grad[..., 0].any() and probs.grad[..., 1].any()


@pytest.mark.parametrize("c", [2, 9])
def test_multi_tversky(c):
    logits, labels = logits_and_labels(c, seed=4)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    compare(jtversky.multi_tversky_loss, as_torch(tl.multi_tversky_loss), probs, labels)


def test_tversky_gradient_ignores_the_upstream_factor():
    logits, labels = logits_and_labels(2, seed=5)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    base, g1 = compare(jtversky.multi_tversky_loss, as_torch(tl.multi_tversky_loss), probs, labels)
    scaled, g15 = compare(lambda p, lab: 1.5 * jtversky.multi_tversky_loss(p, lab),
                          as_torch(lambda p, lab: 1.5 * tl.multi_tversky_loss(p, lab)), probs, labels)
    assert scaled == pytest.approx(1.5 * base, rel=1e-6)
    np.testing.assert_array_equal(g15, g1)


def test_tversky_forces_alpha_and_beta():
    # the reference's constants: TP / (TP + 0.7 FP + 0.3 FN + 1e-6) from hard labels
    _, labels = logits_and_labels(2, seed=6)
    p = np.random.default_rng(7).random(SHAPE).astype(np.float32)
    input2 = torch.from_numpy(np.stack([1 - p, p], -1))
    hard, t = (p > 0.5).reshape(2, -1), labels.reshape(2, -1) == 1
    tp, fp, fn = ((hard & t).sum(1), (hard & ~t).sum(1), (~hard & t).sum(1))
    expected = np.mean(1 - tp / (tp + 0.7 * fp + 0.3 * fn + 1e-6))
    got = tl.focal_binary_tversky(input2, torch.from_numpy(labels == 1)).item()
    assert got == pytest.approx(expected, rel=1e-6)


@pytest.mark.parametrize("min_kept,ignore", [(0, 19), (0, None), (500, 19), (5000, 19)])
def test_ohem(min_kept, ignore):
    logits, labels = logits_and_labels(3, seed=8, ignore=19 if ignore is not None else None)
    compare(lambda x, lab: johem.ohem_cross_entropy(x, lab, min_kept=min_kept, ignore_index=ignore),
            as_torch(lambda x, lab: tl.ohem_cross_entropy(x, lab, min_kept=min_kept,
                                                          ignore_index=ignore)),
            logits, labels)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_l1(masked):
    rng = np.random.default_rng(9)
    pred = rng.standard_normal(SHAPE + (1,)).astype(np.float32)
    gt = np.where(rng.random(SHAPE + (1,)) < 0.3, 0, rng.random(SHAPE + (1,))).astype(np.float32)
    mask = gt > 0 if masked else None
    compare(lambda x, g: jdisp.masked_l1(x, g, None if mask is None else jnp.asarray(mask)),
            lambda x, g: tl.masked_l1(x, torch.from_numpy(g),
                                      None if mask is None else torch.from_numpy(mask)),
            pred, gt)


SEG_CASES = {
    "default": (("cross_entropy", "lovasz_loss"), "roses"),
    "bench": (("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss"), "roses"),
    "cityscapes": (("cross_entropy", "lovasz_loss", "ohm_loss"), "cityscapes"),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_compose_seg_loss(case):
    losses, dataset = SEG_CASES[case]
    n = 19 if dataset == "cityscapes" else 2
    logits, labels = logits_and_labels(n, seed=10)
    if dataset == "cityscapes":
        labels[np.random.default_rng(11).random(SHAPE) < 0.2] = 19  # the ignore channel
    gt_full = np.eye(n + (dataset == "cityscapes"), dtype=np.float32)[labels]
    compare(jdispatch.compose_seg_loss(losses, dataset, n, seg_weight=dataset == "cityscapes"),
            as_torch(tl.compose_seg_loss(losses, dataset, n, seg_weight=dataset == "cityscapes")),
            logits, gt_full)


@pytest.mark.parametrize("dataset", ["roses", "kitti"])
def test_compose_disp_loss(dataset):
    rng = np.random.default_rng(12)
    pred = rng.standard_normal(SHAPE + (1,)).astype(np.float32)
    gt = np.where(rng.random(SHAPE + (1,)) < 0.3, 0, rng.random(SHAPE + (1,))).astype(np.float32)
    seg = np.zeros(SHAPE + (2,), np.float32)
    jfn = jdispatch.compose_disp_loss(["cross_entropy"], dataset, "smallOutSeg")
    tfn = tl.compose_disp_loss(["cross_entropy"], dataset)
    compare(lambda x, g: jfn(None, jnp.asarray(seg), g, x),
            lambda x, g: tfn(torch.from_numpy(g), x), pred, gt)


@pytest.mark.parametrize("name", ["area_ce", "dice_loss", "binary_ce"])
def test_unported_losses_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.compose_seg_loss(["cross_entropy", name], "roses", 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.compose_disp_loss(["smooth_grad"], "roses")


# every ported net, by output type: sdnet_mini_ext smallOutSeg, sdnet_mini
# smallOutPair (single-head), sdnet and sdnetv2 two_out
PORTED_NETS = ("sdnet_mini_ext", "sdnet_mini", "sdnet", "sdnetv2")


def loss_configs(net, losses=("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")):
    jcfg, tcfg = JaxConfig(), PMTConfig()
    for cfg in (jcfg, tcfg):
        cfg.model.net = net
        cfg.loss.losses = losses
    return jcfg, tcfg


@pytest.mark.parametrize("net", PORTED_NETS)
def test_make_losses_fn_matches_jax(net):
    """The whole loss of each ported net's output type and its logs, the
    port's ``make_losses_fn`` against the JAX package's on the same outputs
    (seg2 unlike seg1, so a head-2 loss would show), within 1e-5 relative;
    sdnet_mini counts head 1 only."""
    rng = np.random.default_rng(7)
    out = {k: (2 * rng.standard_normal(SHAPE + (c,))).astype(np.float32)
           for k, c in (("seg1", 2), ("seg2", 2), ("disp1", 1), ("disp2", 1))}
    labels = rng.integers(0, 2, SHAPE)
    batch = {"left": rng.standard_normal(SHAPE + (3,), dtype=np.float32),
             "seg": np.eye(2, dtype=np.float32)[labels],
             "disp": rng.random(SHAPE + (1,), dtype=np.float32)}
    jcfg, tcfg = loss_configs(net)
    assert tcfg.model.output_type == jcfg.model.output_type
    ref_loss, ref_logs = jax_make_losses_fn(jcfg)(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    losses = make_losses_fn(tcfg)
    tout = {k: torch.from_numpy(v) for k, v in out.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, logs = losses(tout, tbatch)
    for k, v in logs.items():
        assert abs(v.item() - float(ref_logs[k])) <= REL * abs(float(ref_logs[k])), (k, v, ref_logs[k])
    head1 = tl.compose_seg_loss(["cross_entropy"], "roses", 2)(tout["seg1"], tbatch["seg"])
    loss_seg = logs["loss_seg"].item()
    if net == "sdnet_mini":  # head 1 only: seg2 does not count
        assert loss_seg == pytest.approx(head1.item(), rel=1e-6)
        assert losses(dict(tout, seg2=-tout["seg2"]), tbatch)[0].item() == loss.item()
    else:
        assert loss_seg > head1.item() * (1 + 1e-3)


@pytest.mark.parametrize("field,value,item", [
    ("net", "sdnet_seg", "12.7"), ("net", "dsnet_warp", "12.7"), ("net", "dsnet_warp_disp", "12.7"),
    ("net", "dsnet_warp_disp_consist", "12.7"), ("net", "sdnet_mini_ext_edge", "12.7"),
    ("net", "deeplab", "12.7"), ("net", "pspnet", "12.7"), ("hanet", True, "12.4"),
    ("multaskloss", 1, "12.7"),
])
def test_unported_output_types_raise(field, value, item):
    _, cfg = loss_configs("sdnet_mini_ext")
    setattr(cfg.model, field, value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, item {item}"):
        make_losses_fn(cfg)
