"""The port's importers of the Ext_small nets and of a MobileNetV3-Large
trunk against the JAX package's (``import_ext_small``,
``import_mobilenetv3_backbone``), bit-equal through ``load_jax_variables``
as in ``test_torch_trunk_import.py``; and the two paths a user takes
through ``Session``: a reference ``.pth.tar`` of an Ext_small net or the
dlab net restores every tensor, and ``-pretrained_path`` grafts a
MobileNetV3-Large in cuevhv's layout (its classifier ignored) into the
trunk and nothing else."""
import pytest
import torch
import torch.nn as nn
from test_torch_trunk_import import Recorded, check_importers_agree
from torch_port import net_configs, reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.mobilenetv3 import (
    MobileNetV3LargeFeatures,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import_families as jtf


@pytest.mark.parametrize("net", ["sdnet_mini_ext_small", "sdnet_mini_ext_small_edge",
                                 "sdnet_mini_ext_small_edgev2"])
def test_ext_small_importers_agree_bit_for_bit(net, monkeypatch):
    ref = check_importers_agree(net, {}, monkeypatch)
    assert ("conv2d_ba2.0.layers.0.c2d.weight" in ref) == net.endswith("_edge")


def cuevhv_mobilenet(seed):
    """A MobileNetV3-Large state dict in cuevhv's layout, from a seeded
    port trunk (``backbone_entries`` inverted), with a classifier."""
    trunk = tmodels.init_parameters(MobileNetV3LargeFeatures(), torch.Generator().manual_seed(seed))
    holder = nn.Module()
    holder.bb = trunk
    sd = ti.export_state_dict(holder, ti.backbone_entries(trunk, "bb", ""))
    sd.update({"classifier.0.weight": torch.zeros(1280, 960), "classifier.0.bias": torch.zeros(1280)})
    return trunk, sd


def test_mobilenet_backbone_importers_agree():
    trunk, sd = cuevhv_mobilenet(4)
    assert "features.4.conv.5.fc.0.weight" in sd and "features.1.conv.3.fc.2.bias" not in sd
    mine = MobileNetV3LargeFeatures()
    ti.load_port_state(mine, ti.import_mobilenetv3_backbone(sd, mine))
    theirs = MobileNetV3LargeFeatures()
    seen = set()
    params, stats = jtf.import_mobilenetv3_backbone({k: Recorded(k, v.numpy(), seen)
                                                     for k, v in sd.items()})
    tmodels.load_jax_variables(theirs, params, stats)
    assert seen == {k for k in sd if not k.startswith("classifier.")}
    a, b, src = mine.state_dict(), theirs.state_dict(), trunk.state_dict()
    for k in src:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], src[k]), k


def test_pretrained_path_grafts_a_mobilenet(tmp_path):
    trunk, sd = cuevhv_mobilenet(5)
    path = str(tmp_path / "mobilenetv3-large.pth")
    torch.save(sd, path)
    _, cfg = net_configs("sdnet_mini_ext", backbone="mobilenet", pretrained_path=path)
    session = Session(cfg, device="cpu")
    session.init_state()
    _, plain_cfg = net_configs("sdnet_mini_ext", backbone="mobilenet")
    plain = tmodels.get_network(plain_cfg, device="cpu", seed=0)
    got, want = session.model.state_dict(), plain.state_dict()
    for k, v in trunk.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["features.backbone." + k], v), k
    assert all(torch.equal(got[k], want[k]) for k in want if not k.startswith("features.backbone."))


@pytest.mark.parametrize("net", ["sdnet_mini_ext_small_edge", "sdnet_mini_ext_dlab"])
def test_session_restores_a_reference_checkpoint(net, tmp_path):
    _, cfg = net_configs(net)
    with reduced_depth():
        source = tmodels.get_network(cfg, device="cpu", seed=7)
        path = str(tmp_path / "model.pth.tar")
        sd = ti.export_state_dict(source, ti.entries_for(cfg, source))
        torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
        session = Session(cfg, device="cpu")
        session.init_state()
        assert session.restore(path) == (0, [])
    got = session.model.state_dict()
    for k, v in source.state_dict().items():
        assert torch.equal(got[k], v), k
