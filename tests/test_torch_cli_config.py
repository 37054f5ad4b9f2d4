"""The port's ``config_from_args`` against the JAX package's: the same argv
line gives the same config (every field of every dataclass), the same
``model_id()`` and the same ``to_json()``, exactly."""
import dataclasses

import pytest

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config as tconfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import config as jconfig

DATA = ("-colorL ds8/colorL.txt -colorR ds8/colorR.txt -seg ds8/seg.txt -disp ds8/disp.txt "
        "-inst ds8/inst.txt -colorL_test ds8/colorL_test.txt -colorR_test ds8/colorR_test.txt "
        "-seg_test ds8/seg_test.txt -disp_test ds8/disp_test.txt -inst_test ds8/inst_test.txt ")
# a training line of the JAX package's documented CLI recipe (sdnet_mini on an 8-pair fixture)
RECIPE = (DATA + "-net sdnet_mini -backbone densenet -corrType 1dcorr -crop 32 64 -b 8 -e 2 "
          "-loss cross_entropy -output_activation linear -datasetName roses -train 1 -w_savePath run1")
ARGV = {
    "defaults": "",
    "recipe": RECIPE,
    "f16": RECIPE + " -f16 1",
    "torch_amp": RECIPE + " -torch_amp 1 -gpu_n 0,1 -n 2 -nr 1",
    "slide_window": RECIPE + " -train 0 -slide_window 2 -load_weights run1/x -show_results 0",
    "freeze_bn": RECIPE + " -freeze_bn 1 -crop 256",
    "acmt_grad": RECIPE + " -acmt_grad 2 -optimType sgd -segWeight 1",
    "sdnet_2dcorr": (DATA + "-corrType 2dcorr -net sdnet -loss cross_entropy lovasz_loss "
                     "tversky_loss ohm_loss -crop 256 512 -b 8 -e 100 -datasetName roses"),
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_config_from_args_matches_jax(name):
    argv = ARGV[name].split()
    got, ref = tconfig.config_from_args(argv), jconfig.config_from_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.model_id() == ref.model_id()
    assert got.to_json() == ref.to_json()
    assert got.parallel.bf16 == (name in ("f16", "torch_amp"))


def test_parsers_have_the_same_flags():
    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), repr(a.default), a.nargs, a.type)
                      for a in parser._actions)

    assert flags(tconfig.build_arg_parser()) == flags(jconfig.build_arg_parser())


def test_from_json_round_trip():
    cfg = tconfig.config_from_args(ARGV["acmt_grad"].split())
    assert tconfig.PMTConfig.from_json(cfg.to_json()) == cfg
