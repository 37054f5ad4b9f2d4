"""The port's on-device metrics against the JAX package's: confusion
matrices equal exactly, scalars within 1e-6 (NaN where JAX gives NaN)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.metrics import (
    disp_metrics as t_disp_metrics,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.metrics import (
    seg_batch_metrics as t_seg_metrics,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    compute_metrics as t_compute_metrics,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.metrics import (
    disp_metrics as j_disp_metrics,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.metrics import (
    seg_batch_metrics as j_seg_metrics,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training.step import (
    compute_metrics as j_compute_metrics,
)

TOL = 1e-6
SHAPE = (2, 16, 24)


def _case(seed, n_labels=2, ignore=True, n_fg=None):
    """logits (B,H,W,n_fg), one-hot gt with an ignore channel, disparities
    with some gt == 0 pixels, a padding mask."""
    rng = np.random.default_rng(seed)
    n_fg = n_labels if n_fg is None else n_fg
    logits = rng.standard_normal(SHAPE + (n_fg,)).astype(np.float32)
    labels = rng.integers(0, n_labels + int(ignore), SHAPE)
    seg = np.eye(n_labels + 1, dtype=np.float32)[labels]
    pred = rng.uniform(0.0, 1.0, SHAPE + (1,)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, SHAPE + (1,)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.2] = 0.0
    mask = (rng.uniform(size=SHAPE) < 0.8).astype(np.float32)
    return logits, seg, pred, gt, mask


def _check(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("n_labels,n_fg", [(2, 2), (9, 9), (2, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_seg_batch_metrics(n_labels, n_fg, masked):
    logits, seg, _, _, mask = _case(0, n_labels, n_fg=n_fg)
    pm = mask if masked else None
    ref = j_seg_metrics(jnp.asarray(logits), jnp.asarray(seg), n_labels,
                        None if pm is None else jnp.asarray(pm))
    got = t_seg_metrics(torch.from_numpy(logits), torch.from_numpy(seg), n_labels,
                        None if pm is None else torch.from_numpy(pm))
    np.testing.assert_array_equal(got.confusion.numpy(), np.asarray(ref.confusion))
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("max_disp", [1.0, 100.0])
@pytest.mark.parametrize("mask_invalid", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_disp_metrics(max_disp, mask_invalid, masked):
    _, seg, pred, gt, mask = _case(1)
    pm = mask if masked else None
    ref = j_disp_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(seg), max_disp,
                         mask_invalid=mask_invalid,
                         pixel_mask=None if pm is None else jnp.asarray(pm))
    got = t_disp_metrics(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(seg),
                         max_disp, mask_invalid=mask_invalid,
                         pixel_mask=None if pm is None else torch.from_numpy(pm))
    for g, r in zip(got, ref):
        _check(g, r)


@pytest.mark.parametrize("dataset", ["roses", "cityscapes"])
def test_compute_metrics(dataset):
    n = {"roses": 2, "cityscapes": 19}[dataset]
    logits, seg, pred, gt, _ = _case(2, n)
    jcfg, tcfg = JaxConfig(), PMTConfig()
    jcfg.data.dataset_name = tcfg.data.dataset_name = dataset
    out = {"seg1": logits, "seg2": logits[..., ::-1].copy(), "disp1": pred}
    batch = {"seg": seg, "disp": gt}
    ref = j_compute_metrics(jcfg, {k: jnp.asarray(v) for k, v in out.items()},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    got = t_compute_metrics(tcfg, {k: torch.from_numpy(v) for k, v in out.items()},
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith("conf"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        _check(got[k], ref[k])
