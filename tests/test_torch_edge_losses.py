"""``ops/edges.py`` (gradient magnitude, gaussian, box counts), the
dual-task edge regularizer fed the uniform sample JAX draws, and the
disparity stack with the edge-aware smoothness, in the port against the JAX
package's: value and input gradient at (2,16,32,C), fp32 on the CPU (bounds
as in ``test_torch_losses.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_losses import SHAPE, compare, logits_and_labels
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import losses as tl
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import dispatch as jdispatch


@pytest.mark.parametrize("dataset,output_type", [("roses", "smallOutSeg"), ("kitti", "smallOutSeg"),
                                                 ("roses", "multitask")])
def test_compose_disp_loss_smooth_grad(dataset, output_type):
    """smooth_grad beside the masked L1 (which the multitask output type
    leaves out), d/d(disparity)."""
    rng = np.random.default_rng(15)
    pred = 30 * rng.random(SHAPE + (1,)).astype(np.float32)
    gt = np.where(rng.random(SHAPE + (1,)) < 0.3, 0, 30 * rng.random(SHAPE + (1,))).astype(np.float32)
    left = rng.standard_normal(SHAPE + (3,)).astype(np.float32)
    seg = np.eye(2, dtype=np.float32)[rng.integers(0, 2, SHAPE)]
    losses = ("cross_entropy", "smooth_grad")
    jfn = jdispatch.compose_disp_loss(losses, dataset, output_type)
    tfn = tl.compose_disp_loss(losses, dataset, output_type)
    compare(lambda x, g: jfn(jnp.asarray(left), jnp.asarray(seg), g, x),
            lambda x, g: tfn(torch.from_numpy(g), x, torch.from_numpy(left), torch.from_numpy(seg)),
            pred, gt)


@pytest.mark.parametrize("op", ["grad_mag", "grad_mag_unnormalized", "gaussian", "box_valid",
                                "box_same_zero"])
def test_edge_ops_match_jax(op):
    """ops/edges.py, value and input gradient of a fixed projection."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import edges as te
    from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops import edges as je

    fns = {"grad_mag": (je.compute_grad_mag, te.compute_grad_mag),
           "grad_mag_unnormalized": (lambda x: je.compute_grad_mag(x, False),
                                     lambda x: te.compute_grad_mag(x, False)),
           "gaussian": (je.gaussian_smooth, te.gaussian_smooth),
           "box_valid": (lambda x: je.box_count(x, 5), lambda x: te.box_count(x, 5)),
           "box_same_zero": (lambda x: je.box_count(x, 3, "SAME_ZERO"),
                             lambda x: te.box_count(x, 3, "SAME_ZERO"))}
    jfn, tfn = fns[op]
    x = np.random.default_rng(19).standard_normal(SHAPE + (3,)).astype(np.float32)
    proj = np.random.default_rng(20).standard_normal(np.asarray(jfn(jnp.asarray(x))).shape)
    proj = proj.astype(np.float32)
    compare(lambda a: jnp.sum(jfn(a) * proj), lambda a: (tfn(a) * torch.from_numpy(proj)).sum(), x)


def test_dual_task_loss_fed_jax_uniform():
    """The gumbel-softmax boundary loss, its uniform sample the one
    ``jax.random.uniform(key, shape)`` draws (19 classes and cityscapes'
    ignore channel); and ground truth without that channel raises."""
    from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import edge as jedge

    logits, labels = logits_and_labels(19, seed=21, ignore=19)
    gt_full = np.eye(20, dtype=np.float32)[labels]
    key = jax.random.PRNGKey(5)
    uniform = torch.from_numpy(np.array(jax.random.uniform(key, logits.shape)))
    compare(lambda x, g: jedge.dual_task_loss(key, x, g),
            lambda x, g: tl.dual_task_loss(x, torch.from_numpy(g), uniform=uniform), logits, gt_full)
    with pytest.raises(ValueError, match="ignore channel"):
        tl.dual_task_loss(torch.zeros(SHAPE + (2,)), torch.zeros(SHAPE + (2,)))
