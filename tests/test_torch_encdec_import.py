"""The port's EncoderDecoderNet importer (``utils/torch_import.py:
encdec_entries``/``import_encdec``) against the JAX package's
``import_encdec`` (``utils/torch_import_families.py``), bit-equal through
``load_jax_variables`` with every reference key read: a reference-layout
dict written from a seeded port model with every leaf non-zero
(``export_state_dict``) imports into a second model through the port's
importer and into a third through the JAX importer; all three agree
exactly. One case a decoder type, each on its own encoder: the SCSE decoder
on resnet50 (bottleneck blocks), OC on resnet34 and SE-IBN on resnet18
(basic blocks, identity layer-1 skips). The reference's
``ConvTranspose2d(4, 2, padding=1)`` weight (I, O, kh, kw) lands flipped in
space in ``SameConvTranspose2d``'s conv layout, where the JAX importer flips
it into flax's (kh, kw, I, O) kernel.
"""
import pytest
import torch
from test_torch_pth_import import Recorded
from torch_port import nonzero_leaves, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import as ti
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.utils import torch_import_families as jtf

CASES = {"unet_scse": "resnet50", "unet_oc": "resnet34", "unet_seibn": "resnet18"}


def model(dec_type, seed):
    net = tmodels.EncoderDecoderNet(5, CASES[dec_type], dec_type, 4)
    return nonzero_leaves(tmodels.init_parameters(net, torch.Generator().manual_seed(seed)), seed)


@pytest.mark.parametrize("dec_type", sorted(CASES))
def test_encdec_importer_agrees_bit_for_bit(dec_type):
    source, mine, theirs = (model(dec_type, s) for s in (1, 2, 3))
    ref = ti.export_state_dict(source, ti.encdec_entries(source))
    ti.load_port_state(mine, ti.import_encdec(ref, mine))
    seen = set()
    params, stats = jtf.import_encdec({k: Recorded(k, v.numpy(), seen) for k, v in ref.items()},
                                      enc_type=CASES[dec_type], dec_type=dec_type)
    tmodels.load_jax_variables(theirs, params, stats)
    assert seen == set(ref)
    a, b, src = mine.state_dict(), theirs.state_dict(), source.state_dict()
    for k in src:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], src[k]), k
