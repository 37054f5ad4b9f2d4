"""``make_losses_fn`` for the output types of the warp, deeplab and PSMNet nets against
the JAX package's, on the same outputs (every head unlike the others, so a
head that counts or not shows), fp32 on the CPU, within 1e-6 relative:
smallOutWarp (``sdnet_seg``: the L1 zeroed, the photo-consistency of
``warped_right`` instead), ThreeOutPuts (the warp nets: head 1's loss on
seg3 too), ThreeOutPutsDisp, ThreeOutPutsDispConsist (both), deeplab (one
head), deeplab_mod (two) and pspnet (one); and ``photo_consistency``
alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.losses import photo_consistency
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_losses_fn
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.losses import disp as jdisp
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training.step import (
    make_losses_fn as jax_make_losses_fn,
)

SHAPE = (2, 16, 32)
REL = 1e-6
STACK = ("cross_entropy", "lovasz_loss", "ohm_loss")
# net -> its output type
NETS = {"sdnet_seg": "smallOutWarp", "dsnet_warp": "ThreeOutPuts",
        "dsnet_warp_disp": "ThreeOutPutsDisp", "dsnet_warp_disp_consist": "ThreeOutPutsDispConsist",
        "deeplab": "deeplab", "deeplab_mod": "deeplab_mod", "pspnet": "pspnet"}


def _data(seed):
    rng = np.random.default_rng(seed)
    keys = (("seg1", 2), ("seg2", 2), ("seg3", 2), ("disp1", 1), ("disp2", 1), ("warped_right", 3))
    out = {k: (2 * rng.standard_normal(SHAPE + (c,))).astype(np.float32) for k, c in keys}
    batch = {"left": rng.standard_normal(SHAPE + (3,), dtype=np.float32),
             "seg": np.eye(2, dtype=np.float32)[rng.integers(0, 2, SHAPE)],
             "disp": rng.random(SHAPE + (1,), dtype=np.float32)}
    return out, batch


@pytest.mark.parametrize("net", sorted(NETS))
def test_make_losses_fn_matches_jax(net):
    jcfg, cfg = JaxConfig(), PMTConfig()
    for c in (jcfg, cfg):
        c.model.net, c.loss.losses = net, STACK
    assert cfg.model.output_type == jcfg.model.output_type == NETS[net]
    out, batch = _data(1)
    _, ref = jax_make_losses_fn(jcfg)({k: jnp.asarray(v) for k, v in out.items()},
                                      {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(0))
    _, got = make_losses_fn(cfg)({k: torch.from_numpy(v) for k, v in out.items()},
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(ref)
    for k, v in got.items():
        assert abs(v.item() - float(ref[k])) <= REL * abs(float(ref[k])), (k, v.item(), float(ref[k]))


def test_photo_consistency_matches_jax():
    out, batch = _data(2)
    ref = float(jdisp.photo_consistency(jnp.asarray(out["warped_right"]), jnp.asarray(batch["left"])))
    got = photo_consistency(torch.from_numpy(out["warped_right"]), torch.from_numpy(batch["left"]))
    assert abs(got.item() - ref) <= REL * ref
