"""The port's importer of reference checkpoints (``utils/torch_import.py``)
for the zoo's trunks and the dlab net, against the JAX package's importers
through ``load_jax_variables``, torch and numpy only, trunks at
``reduced_depth`` (the JAX importers fix the depth per backbone name, so
their densenet and ResNet readers are cut the same way here).

As in ``test_torch_pth_import.py``: a reference-layout state dict is built
from the port's seeded weights by inverting the port's key map
(``export_state_dict``), then loaded by the port's importer and by the JAX
importer -> ``load_jax_variables``; every tensor is bit-equal between the
two and to the source, and the JAX importer reads every key.

* ``import_minidsnet_ext(..., backbone=B)`` for dn169, dn201, dn161,
  resnet50 and resnet101 (with ``aspp_4``) and efficientnet-b2
  (efficientnet_pytorch's layout);
* ``import_ext_dlab`` with ``import_deeplabv3plus_hanet`` (HANet's
  ResNet3X3), with no_dec3, convDeconvOut 2 and HANet;
* what neither importer maps raises ``NotImplementedError``.
"""
import numpy as np
import pytest
import torch
from torch_port import REDUCED_BLOCKS, REDUCED_RESNET, net_configs, reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import as jti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import_families as jtf

CASES = {
    **{b: ("sdnet_mini_ext", {"backbone": b})
       for b in ("dn169", "dn201", "dn161", "resnet50", "resnet101", "efficientnet-b2")},
    "dlab_no_dec3_cdo2_hanet": ("sdnet_mini_ext_dlab", {
        "ablation": ("no_dec3",), "conv_deconv_out": 2, "hanet": True}),
}


class Recorded:
    """A value that records its key when numpy reads it."""

    def __init__(self, key, array, seen):
        self.key, self.array, self.seen = key, array, seen

    def __array__(self, dtype=None, copy=None):
        self.seen.add(self.key)
        return self.array if dtype is None else self.array.astype(dtype)


def cut_jax_importers(monkeypatch):
    """The JAX importers' densenet and ResNet readers at reduced depth."""
    densenet, resnet, hanet = jti.import_densenet121, jti.import_resnet_deeplab, jtf.import_deeplabv3plus_hanet
    monkeypatch.setattr(jti, "import_densenet121",
                        lambda sd, block_config=None: densenet(sd, REDUCED_BLOCKS))
    monkeypatch.setattr(jti, "import_resnet_deeplab", lambda sd, layers=None: resnet(sd, REDUCED_RESNET))
    monkeypatch.setattr(jtf, "import_deeplabv3plus_hanet",
                        lambda sd, prefix="resnet_features", layers=None: hanet(sd, prefix,
                                                                                REDUCED_RESNET))


def jax_import(cfg, sd):
    m = cfg.model
    if m.net == "sdnet_mini_ext_dlab":
        return jtf.import_ext_dlab(sd, conv_deconv_out=m.conv_deconv_out, ablation=m.ablation,
                                   hanet=bool(m.hanet))
    if m.net.startswith("sdnet_mini_ext_small"):
        variant = {"sdnet_mini_ext_small": "v0", "sdnet_mini_ext_small_edge": "edge",
                   "sdnet_mini_ext_small_edgev2": "v2"}[m.net]
        return jtf.import_ext_small(sd, variant=variant)
    return jti.import_minidsnet_ext(sd, use_att=m.use_att, conv_deconv_out=m.conv_deconv_out,
                                    ablation=m.ablation, aspp_mod=m.aspp, hanet=bool(m.hanet),
                                    backbone=m.backbone)


def check_importers_agree(net, options, monkeypatch):
    cut_jax_importers(monkeypatch)
    _, cfg = net_configs(net, **options)
    with reduced_depth():
        source, mine, theirs = (tmodels.get_network(cfg, device="cpu", seed=s) for s in (1, 2, 3))
    ref = ti.export_state_dict(source, ti.entries_for(cfg, source))
    ti.load_port_state(mine, ti.import_state_dict(cfg, mine, ref))
    seen = set()
    params, stats = jax_import(cfg, {k: Recorded(k, v.numpy(), seen) for k, v in ref.items()})
    tmodels.load_jax_variables(theirs, params, stats)
    assert seen == set(ref)
    a, b, src = mine.state_dict(), theirs.state_dict(), source.state_dict()
    for k in src:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], src[k]), k
    return ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_importers_agree_bit_for_bit(name, monkeypatch):
    ref = check_importers_agree(*CASES[name], monkeypatch)
    if name.startswith("resnet"):
        assert "aspp_4.conv1.weight" in ref and "resnet_features.resnet_features.layer4.2.conv2.weight" in ref
    if name.startswith("efficientnet"):
        assert "resnet_features.resnet_features._blocks.0._se_reduce.bias" in ref
    if name.startswith("dlab"):
        assert "resnet_features.layer0.6.weight" in ref and "resnet_features.aspp.img_conv.0.weight" in ref


@pytest.mark.parametrize("net,options", [
    ("sdnet_mini_ext", {"backbone": "mobilenet"}),
    ("sdnet_mini_ext_small", {"aspp": 1}),
    ("sdnet_mini_ext_small", {"backbone": "resnet50"}),
])
def test_what_the_jax_importers_do_not_map_raises(net, options):
    _, cfg = net_configs(net, **options)
    with reduced_depth():
        model = tmodels.get_network(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 3"):
        ti.import_state_dict(cfg, model, {})
    assert np.isfinite(next(model.parameters()).detach().numpy()).all()
