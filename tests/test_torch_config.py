"""The port's configuration dataclasses (``core/config.py``): every class's
type hints resolve, and ``output_type_for`` (the reference's outputType)
gives the JAX package's answer for every net it names."""
import dataclasses
import typing

import pytest

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config as tconfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import config as jconfig

CLASSES = sorted(n for n, c in vars(tconfig).items()
                 if dataclasses.is_dataclass(c) and c.__module__ == tconfig.__name__)


@pytest.mark.parametrize("name", CLASSES)
def test_type_hints_resolve(name):
    cls = getattr(tconfig, name)
    hints = typing.get_type_hints(cls)
    assert set(hints) == {f.name for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("hanet,multaskloss", [(False, 0), (True, 0), (False, 1)])
def test_output_type_for_matches_jax(hanet, multaskloss):
    for net in jconfig.VALID_NETS:
        assert (tconfig.output_type_for(net, hanet, multaskloss)
                == jconfig.output_type_for(net, hanet, multaskloss)), net


def test_model_config_output_type():
    for net, ot in (("sdnet_mini_ext", "smallOutSeg"), ("sdnet_mini", "smallOutPair"),
                    ("sdnet", "two_out"), ("sdnetv2", "two_out")):
        assert tconfig.ModelConfig(net=net).output_type == ot
