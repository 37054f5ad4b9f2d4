"""The segmentation losses of the eighth slice in the port against the JAX
package's ``losses/seg.py``: value and input gradient at (2,16,32,C), fp32
on the CPU, inputs from numpy seeds, each fed what the dispatcher feeds it
(the sigmoid for binary CE, the log-softmax or softmax otherwise). Bounds as
in ``test_torch_losses.py``: values within 1e-5 relative, gradients within
1e-5 * max|ref|. The area losses take ground truth made of 4x4 blocks, so
some windows lie inside one class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses import SHAPE, compare, logits_and_labels
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import losses as tl
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import seg as jseg


def _onehot(c, seed, ignore=False):
    labels = np.random.default_rng(seed).integers(0, c + ignore, SHAPE)
    return np.eye(c + ignore, dtype=np.float32)[labels]


def _weights(c):
    return np.linspace(0.5, 2.0, c, dtype=np.float32)


# loss -> (JAX function of the logits, the port's, the ground truth's seed
# and its extra ignore channel): the losses of the eighth slice, each fed
# what the dispatcher feeds it
NEW_SEG_LOSSES = {
    "binary_ce": (lambda x, g: jseg.binary_ce(jax.nn.sigmoid(x), g),
                  lambda x, g: tl.binary_ce(torch.sigmoid(x), g), False),
    "binary_ce_weighted": (lambda x, g: jseg.binary_ce(jax.nn.sigmoid(x), g, jnp.asarray(_weights(5))),
                           lambda x, g: tl.binary_ce(torch.sigmoid(x), g, torch.from_numpy(_weights(5))),
                           False),
    "categorical_nll": (lambda x, g: jseg.categorical_nll(jax.nn.log_softmax(x), g),
                        lambda x, g: tl.categorical_nll(x.log_softmax(-1), g), True),
    "categorical_nll_weighted": (
        lambda x, g: jseg.categorical_nll(jax.nn.log_softmax(x), g, jnp.asarray(_weights(5))),
        lambda x, g: tl.categorical_nll(x.log_softmax(-1), g, torch.from_numpy(_weights(5))), True),
    "tversky_loss2": (lambda x, g: jseg.tversky_loss2(jax.nn.softmax(x), g, jnp.asarray(_weights(5))),
                      lambda x, g: tl.tversky_loss2(x.softmax(-1), g, torch.from_numpy(_weights(5))),
                      False),
    "dice_loss": (lambda x, g: jseg.dice_loss(jax.nn.log_softmax(x), g),
                  lambda x, g: tl.dice_loss(x.log_softmax(-1), g), False),
    "dice_entropy": (lambda x, g: jseg.dice_entropy(jax.nn.log_softmax(x), g),
                     lambda x, g: tl.dice_entropy(x.log_softmax(-1), g), False),
    "area_ce_7": (lambda x, g: jseg.area_ce_loss(jax.nn.log_softmax(x), g, 7),
                  lambda x, g: tl.area_ce_loss(x.log_softmax(-1), g, 7), False),
    "area_ce_5": (lambda x, g: jseg.area_ce_loss(jax.nn.log_softmax(x), g, 5),
                  lambda x, g: tl.area_ce_loss(x.log_softmax(-1), g, 5), False),
    "area_hinge": (lambda x, g: jseg.area_hinge_loss(jax.nn.log_softmax(x), g),
                   lambda x, g: tl.area_hinge_loss(x.log_softmax(-1), g), False),
}


@pytest.mark.parametrize("name", sorted(NEW_SEG_LOSSES))
def test_seg_loss_matches_jax(name):
    jfn, tfn, ignore = NEW_SEG_LOSSES[name]
    logits = logits_and_labels(5, seed=16)[0]
    gt = _onehot(5, 17, ignore) if not name.startswith("area") else \
        np.repeat(np.repeat(_onehot(5, 17)[:, ::4, ::4], 4, 1), 4, 2)  # regions inside one class
    if ignore:  # categorical_nll takes gt_full: 19 classes and the ignore channel
        logits = logits_and_labels(19, seed=16)[0]
        gt = np.eye(20, dtype=np.float32)[np.random.default_rng(18).integers(0, 20, SHAPE)]
        jfn, tfn = ((lambda x, g, f=jfn: f(x, g)), (lambda x, g, f=tfn: f(x, g)))
        if name.endswith("weighted"):
            w19 = _weights(19)
            jfn = lambda x, g: jseg.categorical_nll(jax.nn.log_softmax(x), g, jnp.asarray(w19))  # noqa: E731
            tfn = lambda x, g: tl.categorical_nll(x.log_softmax(-1), g, torch.from_numpy(w19))  # noqa: E731
    compare(jfn, lambda x, g: tfn(x, torch.from_numpy(g)), logits, gt)
