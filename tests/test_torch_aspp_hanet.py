"""The port's ``ASPP`` and ``HANetConv`` alone against the JAX package's,
fp32 on the CPU, in eval and train mode (dropout 0 in both packages: a
dropout draw cannot be matched across frameworks).

Weights are the port's seeded init carried to flax
(``torch_port.variables_from_port``). Bounds: outputs and the BatchNorm
running statistics after a train-mode call within 1e-5 * max|ref|. HANet
pools its input's rows to 64 at heights 64 does not divide (45, 100) and
at a height below 64 (32); its position encoding is the sinusoid table or
the learned embedding.
"""
import jax
import numpy as np
import pytest
import torch
from torch_port import torch_threads, variables_from_port  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import blocks
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import aspp as taspp
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import hanet as thanet
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import aspp as jaspp
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import hanet as jhanet

REL = 1e-5


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _close(got, ref, what):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max(), what


def _stats_close(port, jax_stats):
    """Every running statistic of ``port`` against the flax batch_stats."""
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_stats)[0]:
        keys = [k.key for k in path]
        name = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
        _close(port.state_dict()[name].numpy(), leaf, name)
        n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())


def _run(port, module, variables, args, jax_args, train):
    """(port output, flax output, flax batch_stats after the call)."""
    port.train(train)
    with torch.no_grad():
        got = port(*args)
    if train:
        ref, mut = jax.jit(lambda v, *a: module.apply(v, *a, train=True, mutable=["batch_stats"]))(
            variables, *jax_args)
        return got, ref, mut["batch_stats"]
    return got, jax.jit(lambda v, *a: module.apply(v, *a, train=False))(variables, *jax_args), None


@pytest.mark.parametrize("output_stride,cin,hw,train", [
    (32, 32, (12, 20), False), (32, 32, (12, 20), True), (16, 24, (9, 14), True)])
def test_aspp_matches_jax(output_stride, cin, hw, train):
    x = np.random.default_rng(0).standard_normal((2,) + hw + (cin,), dtype=np.float32)
    port = taspp.ASPP(cin, output_stride=output_stride, features=16, dropout=0.0)
    blocks.init_parameters(port, torch.Generator().manual_seed(0))
    module = jaspp.ASPP(output_stride=output_stride, features=16, dropout=0.0)
    variables = variables_from_port(port, lambda k, a: module.init({"params": k}, a),
                                    jax.random.PRNGKey(0), x)
    got, ref, stats = _run(port, module, variables, (_nchw(x),), (x,), train)
    _close(got.permute(0, 2, 3, 1).numpy(), ref, "aspp output")
    if train:
        _stats_close(port, stats)


@pytest.mark.parametrize("x_h,out_h,is_encoding,train", [
    (45, 90, 1, False), (45, 90, 1, True), (100, 200, 0, False), (100, 200, 0, True),
    (32, 64, 1, True)])
def test_hanet_matches_jax(x_h, out_h, is_encoding, train):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, x_h, 24, 64), dtype=np.float32)
    out = rng.standard_normal((2, out_h, 48, 3), dtype=np.float32)
    port = thanet.HANetConv(64, 3, dropout_prob=0.0, is_encoding=is_encoding)
    blocks.init_parameters(port, torch.Generator().manual_seed(0))
    module = jhanet.HANetConv(out_channels=3, pooling="max", pos_rfactor=2, dropout_prob=0.0,
                              is_encoding=is_encoding)
    jpos = jhanet.build_pos_grid(out_h, 48)
    variables = variables_from_port(port, lambda k, a, b, p: module.init({"params": k}, a, b, p),
                                    jax.random.PRNGKey(0), x, out, jpos)
    (got, att), (ref, ref_att), stats = _run(
        port, module, variables, (_nchw(x), _nchw(out), thanet.build_pos_grid(out_h, 48)),
        (x, out, jpos), train)
    _close(got.permute(0, 2, 3, 1).numpy(), ref, "gated output")
    _close(att.transpose(1, 2).numpy(), ref_att, "attention")
    if train:
        _stats_close(port, stats)


def test_hanet_position_rows_follow_the_half_pixel_nearest_rule():
    """The grid's row indices resized to the pooled length as
    ``jax.image.resize(method="nearest")`` does, also where torch's
    floor(dst * in / out) rule would pick other rows."""
    idx = torch.arange(37).reshape(1, 37)
    got = thanet._resize_nearest_half_pixel(idx, 64)
    ref = jax.image.resize(np.arange(37, dtype=np.float32).reshape(1, 37, 1), (1, 64, 1), "nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[..., 0].astype(np.int64))
    torch_rule = torch.nn.functional.interpolate(idx[None].float(), 64, mode="nearest")[0]
    assert not torch.equal(torch_rule.long(), got)
