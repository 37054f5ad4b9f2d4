"""The port's importers of the warp, deeplab and PSMNet nets against the JAX package's
(``utils/torch_import_families.py``, ``utils/torch_import.py``), bit-equal
through ``load_jax_variables`` with every reference key read, as in
``test_torch_trunk_import.py``: a reference-layout dict written from a
seeded port model (``export_state_dict`` of ``entries_for``) imports into a
second model through ``import_state_dict`` and into a third through the JAX
importer; all three agree exactly.

* the warp nets (``import_minidsnet_divide``, its four variants) and
  ``sdnet_seg`` (``import_seg_dsnet``), trunks at ``reduced_depth`` (the JAX
  importers' densenet reader cut to match);
* ``deeplab`` on Xception-65 and on the MobileNetV2 encoder
  (``import_sppnet_mono``), ``deeplab_mod`` (``import_sppnet_stereo``),
  ``pspnet`` (``import_psmnet``, the 3-D kernels and the flipped
  ``ConvTranspose3d``), at full depth;
* ``-pretrained_path`` with a bare Xception-65 dict grafts it into
  ``deeplab``'s encoder (``import_xception65_backbone``) and nothing else.
"""
import pytest
import torch
from test_torch_trunk_import import Recorded, cut_jax_importers
from torch_port import net_configs, reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import as jti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import_families as jtf

# name -> (net, model options, the JAX importer)
CASES = {
    "dsnet_warp": ("dsnet_warp", {}, lambda sd: jtf.import_minidsnet_divide(sd, "divide")),
    "dsnet_warp_soft": ("dsnet_warp_soft", {}, lambda sd: jtf.import_minidsnet_divide(sd, "soft")),
    "dsnet_warp_disp": ("dsnet_warp_disp", {}, lambda sd: jtf.import_minidsnet_divide(sd, "disp")),
    "dsnet_warp_disp_consist": ("dsnet_warp_disp_consist", {},
                                lambda sd: jtf.import_minidsnet_divide(sd, "disp2")),
    "sdnet_seg": ("sdnet_seg", {}, lambda sd: jti.import_seg_dsnet(sd, labels=2)),
    "deeplab": ("deeplab", {}, jtf.import_sppnet_mono),
    "deeplab_mobilenetv2": ("deeplab", {"backbone": "mobilenetv2"},
                            lambda sd: jtf.import_sppnet_mono(sd, enc_type="mobilenetv2")),
    "deeplab_mod": ("deeplab_mod", {}, jtf.import_sppnet_stereo),
    "pspnet": ("pspnet", {}, jtf.import_psmnet),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_importers_agree_bit_for_bit(name, monkeypatch):
    net, options, jax_import = CASES[name]
    cut_jax_importers(monkeypatch)
    _, cfg = net_configs(net, **options)
    with reduced_depth():
        source, mine, theirs = (tmodels.get_network(cfg, device="cpu", seed=s) for s in (1, 2, 3))
    ref = ti.export_state_dict(source, ti.entries_for(cfg, source))
    ti.load_port_state(mine, ti.import_state_dict(cfg, mine, ref))
    seen = set()
    params, stats = jax_import({k: Recorded(k, v.numpy(), seen) for k, v in ref.items()})
    tmodels.load_jax_variables(theirs, params, stats)
    assert seen == set(ref)
    a, b, src = mine.state_dict(), theirs.state_dict(), source.state_dict()
    for k in src:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], src[k]), k
    if name == "pspnet":
        assert ref["dres2.conv5.0.weight"].dim() == 5
    if name.startswith("dsnet_warp"):
        assert "resnet_features.branch3_1.1.layers.0.c2d.weight" in ref


def test_pretrained_path_grafts_an_xception65(tmp_path):
    _, cfg = net_configs("deeplab")
    source = tmodels.get_network(cfg, device="cpu", seed=4)
    holder = torch.nn.Module()
    holder.bb = source.encoder
    sd = ti.export_state_dict(holder, ti.xception65_entries(source.encoder, "bb", ""))
    assert "block21.sep_conv3.block.bn_point.running_var" in sd and "block4.conv.weight" not in sd
    sd.update({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)})
    seen = set()
    params, stats = jtf.import_xception65_backbone({k: Recorded(k, v.numpy(), seen) for k, v in sd.items()})
    assert seen == set(sd) - {"fc.weight", "fc.bias"}
    path = str(tmp_path / "xception65.pth")
    torch.save(sd, path)
    _, graft_cfg = net_configs("deeplab", pretrained_path=path)
    session = Session(graft_cfg, device="cpu")
    session.init_state()
    theirs = tmodels.get_network(cfg, device="cpu", seed=5)
    tmodels.load_jax_variables(theirs.encoder, params, stats)
    plain = tmodels.get_network(cfg, device="cpu", seed=0)
    got, want, jax_enc = session.model.state_dict(), plain.state_dict(), theirs.encoder.state_dict()
    for k, v in source.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["encoder." + k], v) and torch.equal(jax_enc[k], v), k
    assert all(torch.equal(got[k], want[k]) for k in want if not k.startswith("encoder."))
