"""Whole trunks built from the port's blocks against the flax trunks of the
JAX package: a narrow DenseNet's taps with randomised variables, and the
original piramidNet with the port's seeded weights; fp32 on the CPU, the
flax init and apply jitted. A file of its own, apart from
``test_torch_blocks.py`` (whose helpers it uses): each trunk takes seconds
to trace and compile, and the suite's workers take files of few cases after
its heavy ones."""
import jax
import numpy as np
import torch
from test_torch_blocks import REL, _x, randomized_variables
from torch_port import torch_threads, variables_from_port  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet as td
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import pyramid as tp
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.blocks import init_parameters
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models.jax_weights import (
    load_jax_variables,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import densenet as jd
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import pyramid as jp


def test_densenet_taps():
    """A narrow DenseNet: every tap (pre-pool transitions, conv0 before norm0,
    relu(norm5)) against the flax trunk."""
    jm = jd.DenseNetFeatures((2, 3, 2, 2), 8, 16)
    tm = td.DenseNetFeatures((2, 3, 2, 2), 8, 16)
    x = _x(3, hw=(64, 96))
    v = randomized_variables(jm, x, 1, jit=True)
    refs = [np.asarray(t) for t in jax.jit(jm.apply)(v, x)]
    load_jax_variables(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        taps = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tm.tap_channels == tuple(r.shape[-1] for r in refs)
    for got, ref in zip(taps, refs):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_piramidnet_v1():
    """The original piramidNet (densenet121, 5 branches on tap 0, 3 named
    branch1_k on tap 2) against flax at 1x64x64: every tap and enriched map,
    with the port's seeded weights as a flax tree (``variables_from_port``,
    no flax init compile), carried back by ``load_jax_variables``. 121 layers
    of fp32 in another summation order: bound 1e-4 * max|ref|."""
    jm, tm = jp.PiramidNetV1(), tp.PiramidNetV1()
    x = _x(3, hw=(64, 64))[:1]
    init_parameters(tm, torch.Generator().manual_seed(0))
    v = variables_from_port(tm, jm.init, jax.random.PRNGKey(0), x)
    refs = [np.asarray(t) for t in jax.jit(jm.apply)(v, x)]
    init_parameters(tm, torch.Generator().manual_seed(1))
    load_jax_variables(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        outs = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(outs) == len(refs) == 7
    assert tm.out_channels == tuple(r.shape[-1] for r in refs) == (64, 128, 256, 512, 1024, 352, 224)
    for got, ref in zip(outs, refs):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
