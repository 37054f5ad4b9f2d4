"""The warp family against the JAX models (``models/warpnets.py``), eval
forward at 1x64x128 in fp32 on the CPU, trunks at ``reduced_depth``
(``torch_port.compare_net``): ``dsnet_warp`` (1dcorr, and 2dcorr),
``dsnet_warp_soft``, ``dsnet_warp_disp`` (the keyword input ``disp_gt``),
``dsnet_warp_disp_consist`` and ``sdnet_seg``, every output within 1e-3 *
max|ref|. The ``warped_right`` of ``dsnet_warp_disp_consist`` and
``sdnet_seg`` is the right image warped by the net's own disparity, which
at random init reaches ~2e3 pixels: its fp32 noise (~1e-2 pixels, 5e-6 of
it, within the bound) moves each warped sample by the image's slope times
that, 1.6e-3 and 2.5e-3 of max|ref| at these inputs. So that output is held
against the JAX op applied to the port's own disparity within 1e-6 (the
disparity itself within 1e-3 * max|ref|).
In train mode ``dsnet_warp_disp`` runs the trunk three times: the left
view, the right view, then the warped right image."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import compare_net, net_configs, reduced_depth, torch_threads, worst_output  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.warpnets import _WARP_DIMS
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.pyramid import PiramidNet2Warp
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.ops.warp import apply_disparity

REL = 1e-3
SHAPE = (1, 64, 128, 3)
CASES = {
    "dsnet_warp": ("dsnet_warp", {}),
    "dsnet_warp_2dcorr": ("dsnet_warp", {"corr_type": "2dcorr"}),
    "dsnet_warp_soft": ("dsnet_warp_soft", {}),
    "dsnet_warp_disp": ("dsnet_warp_disp", {}),
    "dsnet_warp_disp_consist": ("dsnet_warp_disp_consist", {}),
    "sdnet_seg": ("sdnet_seg", {}),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    left, right = (rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))
    # a disparity with holes (disp_gt > 0 masks the warped image)
    disp = np.maximum(rng.uniform(-2.0, 9.0, SHAPE[:3] + (1,)), 0.0).astype(np.float32)
    return left, right, disp


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_net_matches_jax(name):
    net, options = CASES[name]
    left, right, disp = _inputs()
    kw = {"disp_gt": disp} if net == "dsnet_warp_disp" else {}
    ref, got, _ = compare_net(net, left, right, jax_kw=kw,
                              torch_kw={k: torch.from_numpy(v) for k, v in kw.items()}, **options)
    expect = {"seg1", "disp1", "seg2", "disp2", "warped_right"} | ({"seg3"} if net != "sdnet_seg" else set())
    assert set(got) == expect
    if net in ("dsnet_warp_disp_consist", "sdnet_seg"):
        want = np.asarray(apply_disparity(jnp.asarray(right), -jnp.asarray(got["disp1"])))
        np.testing.assert_allclose(got.pop("warped_right"), want, rtol=0, atol=1e-6)
        ref.pop("warped_right")
    rel, key = worst_output(ref, got)
    assert rel <= REL, (key, rel)


def test_warp_dims_are_the_pyramids():
    """The reference constructor's (segnet input, segnet feature) channels
    are the pyramid's b3 and b1 channels on these trunks (full depth)."""
    for backbone, dims in _WARP_DIMS.items():
        with torch.device("meta"):
            c = PiramidNet2Warp(backbone).out_channels
        assert (c[8], c[6]) == dims, backbone


def test_dsnet_warp_disp_runs_the_trunk_three_times_in_train_mode():
    left, right, disp = _inputs(1)
    _, cfg = net_configs("dsnet_warp_disp")
    with reduced_depth():
        port = tmodels.get_network(cfg, device="cpu").train()
    trunk = port.features.backbone
    seen = []
    trunk.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    out = port(torch.from_numpy(left), torch.from_numpy(right), disp_gt=torch.from_numpy(disp))
    assert len(seen) == 3
    to_nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    assert torch.equal(seen[0], to_nchw(left)) and torch.equal(seen[1], to_nchw(right))
    # the third pass: the right image warped by the ground truth, masked
    assert torch.equal(seen[2][:, :, disp[0, :, :, 0] <= 0], torch.zeros_like(seen[2][:, :, disp[0, :, :, 0] <= 0]))
    assert set(out) == {"seg1", "disp1", "seg2", "disp2", "seg3", "warped_right"}
    for k, v in out.items():
        assert torch.isfinite(v).all() and v.shape[:3] == SHAPE[:3]
