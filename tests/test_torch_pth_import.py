"""The port's importer of torch reference checkpoints (``utils/
torch_import.py``) against the JAX package's importer, torch and numpy only
(no JAX compile), trunk at ``reduced_depth``.

For each configuration of ``torch_port.OPTION_CONFIGS`` that the JAX
importer maps, and for ``sdnet_mini``, ``sdnet`` and ``sdnetv2``: a
reference-layout state dict is built from the port's seeded weights by
inverting the port's key map (``export_state_dict``; the densenet in the
reference's own ``denseblock.N`` layout), then loaded two ways, by the
port's importer and by the chain JAX importer -> ``load_jax_variables``;
every tensor must be bit-equal between the two and to the source. Each
value of the dict records when the JAX importer reads it (``np.asarray``):
it must read every key. The multitask modes raise (neither importer maps
their Kendall modules). ``-pretrained_path`` grafts a torchvision-layout or
reference-layout densenet into the trunk. (A ``.pth.tar`` with a ``module.``
prefix and a ``state_dict`` wrapper restores through the eval CLI in
``test_torch_session.py``.)
"""
import pytest
import torch
from torch_port import OPTION_CONFIGS as CONFIGS  # noqa: F401
from torch_port import REDUCED_BLOCKS, reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.densenet import DenseNetFeatures
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import as jti

NETS = {**{k: v for k, v in CONFIGS.items() if not k.startswith("multitask")},
        "sdnet_mini": ("sdnet_mini", {}), "sdnet": ("sdnet", {}), "sdnetv2": ("sdnetv2", {})}
VARIANTS = {"sdnet_mini_ext": "ext", "sdnet_mini_ext_v2": "v2", "sdnet_mini_ext_piramid": "piramid",
            "sdnet_mini_ext_piramid_res": "piramid_res"}


class Recorded:
    """A value that records its key when numpy reads it."""

    def __init__(self, key, array, seen):
        self.key, self.array, self.seen = key, array, seen

    def __array__(self, dtype=None, copy=None):
        self.seen.add(self.key)
        return self.array if dtype is None else self.array.astype(dtype)


def config(net, options):
    cfg = PMTConfig()
    cfg.model.net = net
    for k, v in options.items():
        setattr(cfg.model, k, v)
    return cfg


def jax_import(cfg, sd):
    """The JAX package's importer of the net (its densenet at the reduced
    block config, which it otherwise fixes per backbone)."""
    m = cfg.model
    if m.net in VARIANTS:
        return jti.import_minidsnet_ext(sd, use_att=m.use_att, conv_deconv_out=m.conv_deconv_out,
                                        ablation=m.ablation, aspp_mod=m.aspp, hanet=bool(m.hanet),
                                        variant=VARIANTS[m.net])
    return {"sdnet_mini": jti.import_minidsnet, "sdnet": jti.import_dsnet,
            "sdnetv2": jti.import_dsnetv2}[m.net](sd)


@pytest.mark.parametrize("name", sorted(NETS))
def test_importers_agree_bit_for_bit(name, monkeypatch):
    cfg = config(*NETS[name])
    densenet = jti.import_densenet121
    monkeypatch.setattr(jti, "import_densenet121",
                        lambda sd, block_config=None: densenet(sd, REDUCED_BLOCKS))
    with reduced_depth():
        source = tmodels.get_network(cfg, device="cpu", seed=1)
        mine = tmodels.get_network(cfg, device="cpu", seed=2)
        theirs = tmodels.get_network(cfg, device="cpu", seed=3)
    ref = ti.export_state_dict(source, ti.entries_for(cfg, source))
    assert any(k.startswith("resnet_features.resnet_features.denseblock.") for k in ref)
    ti.load_port_state(mine, ti.import_state_dict(cfg, mine, ref))
    seen = set()
    params, stats = jax_import(cfg, {k: Recorded(k, v.numpy(), seen) for k, v in ref.items()})
    tmodels.load_jax_variables(theirs, params, stats)
    assert seen == set(ref)
    a, b, src = mine.state_dict(), theirs.state_dict(), source.state_dict()
    for k in src:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], src[k]), k


def test_multitask_modes_raise():
    for mode in (1, 2):
        cfg = config("sdnet_mini_ext", {"multaskloss": mode})
        with reduced_depth():
            model = tmodels.get_network(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 11.3"):
            ti.import_state_dict(cfg, model, {})


@pytest.mark.parametrize("layout", ["torchvision", "reference"])
def test_pretrained_path_grafts_a_densenet(tmp_path, layout):
    """-pretrained_path: a torchvision densenet (its classifier ignored) or
    the reference's own densenet layout replaces every trunk tensor and no
    other."""
    trunk = tmodels.init_parameters(DenseNetFeatures(REDUCED_BLOCKS, 32, 64),
                                    torch.Generator().manual_seed(9))
    sd = {"features." + k: v for k, v in trunk.state_dict().items()}
    if layout == "reference":
        sd = ti._torchvision_to_ref_densenet_keys(sd)
    sd.update({"classifier.weight": torch.zeros(10, 128), "classifier.bias": torch.zeros(10)})
    path = str(tmp_path / "densenet.pth")
    torch.save(sd, path)
    cfg = config(*CONFIGS["aspp2"])
    cfg.model.pretrained_path = path
    with reduced_depth():
        session = Session(cfg, device="cpu")
        session.init_state()
        plain = tmodels.get_network(config(*CONFIGS["aspp2"]), device="cpu", seed=0)
    got, want = session.model.state_dict(), plain.state_dict()
    for k, v in trunk.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["features.backbone." + k], v), k
    assert all(torch.equal(got[k], want[k]) for k in want if not k.startswith("features.backbone."))
