"""PSMNet (``pspnet``) against the JAX model (``models/psmnet.py``), fp32 on
the CPU. It has no depth knob, so the reference runs at full depth with
maxdisp 48 at 1x60x120, which ``pad_to_multiple_of_16`` pads at the top and
left to 64x128 (the disparities are cropped back): the eval forward's
disparities within 1e-3 * max|ref|. In train mode the feature net runs once
per view, left then right, and the net also returns the three classifiers'
disparities (``preds``)."""
import jax
import numpy as np
import torch
from torch_port import net_configs, torch_threads, variables_from_port  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.psmnet import (
    pad_to_multiple_of_16,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels

SHAPE = (1, 60, 120, 3)
MAXDISP = 48


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))


def _port():
    _, cfg = net_configs("pspnet", max_disp_psm=MAXDISP)
    return tmodels.get_network(cfg, device="cpu")


def test_psmnet_matches_jax():
    left, right = _pair()
    jcfg, _ = net_configs("pspnet", max_disp_psm=MAXDISP)
    model, port = jmodels.get_network(jcfg), _port()
    variables = variables_from_port(port, lambda k, a, b: model.init({"params": k}, a, b, train=False),
                                    jax.random.PRNGKey(0), left, right)
    ref = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(variables, left, right)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        got = port(torch.from_numpy(left), torch.from_numpy(right))
    assert got["seg1"] is None and got["seg2"] is None and torch.equal(got["disp1"], got["disp2"])
    r = np.asarray(ref["disp1"])
    assert got["disp1"].shape == r.shape == SHAPE[:3] + (1,)
    assert np.abs(got["disp1"].numpy() - r).max() <= 1e-3 * np.abs(r).max()


def test_psmnet_pads_top_left_and_runs_the_feature_net_once_per_view_in_train_mode():
    left, right = (torch.from_numpy(a) for a in _pair(1))
    lp, rp, pad = pad_to_multiple_of_16(left, right)
    assert pad == (4, 8) and torch.equal(lp[:, 4:, 8:], left) and lp[:, :4].abs().max() == 0
    port = _port().train()
    seen = []
    port.feature.first0.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach().clone()))
    out = port(left, right)
    assert len(seen) == 2
    for x, view in zip(seen, (lp, rp)):
        assert torch.equal(x, view.permute(0, 3, 1, 2))
    assert len(out["preds"]) == 3 and out["preds"][2] is out["disp1"]
    for p in out["preds"]:
        assert p.shape == SHAPE[:3] + (1,) and torch.isfinite(p).all()
        assert 0.0 <= p.min() and p.max() <= MAXDISP - 1
