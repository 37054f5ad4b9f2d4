"""The deeplab nets against the JAX models (``models/deeplab.py``), fp32 on
the CPU. Xception-65 has no depth knob, so these references run at full
depth, at a small input: 1x32x32, which the pre-processing pads to 33x33
(odd sizes through every stride-2 layer).

* ``deeplab`` (Xception-65 + ASPP + decoder), ``SPPNetMono`` on the
  MobileNetV2 encoder (built directly: ``mobilenetv2`` is no ``-backbone``)
  and ``deeplab_mod`` (corr1d between the views' block-8 taps, three
  chained decoders), each with the pre- and post-processing (the left view
  alone scaled to [-1, 1], both padded by one; the heads resized with
  align_corners and cropped): every head within 1e-3 * max|ref|.
* In train mode ``deeplab_mod``'s encoder runs once per view, left then
  right, its BatchNorms moving twice and the decoders' once; ``deeplab``
  trains with every BatchNorm in eval mode (the running statistics do not
  move) while the BatchNorm parameters get gradients.
* The eval step with ``-tta 1``, and with ``-tta_scales 0.75 1.25``, on
  ``deeplab`` (its MobileNetV2 encoder) against what the JAX
  ``make_eval_step`` computes for it (its ``evaluation.tta`` over its
  post-processed forward): seg heads within 1e-4 * max|ref|; ``-tta 1`` on
  another net raises the JAX package's ValueError.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import net_configs, port_stats, torch_threads, variables_from_port  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import models as tmodels
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import deeplab as tdl
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    TrainState,
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import models as jmodels
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.evaluation.tta import tta as jax_tta
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import deeplab as jdl
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training import step as jstep

REL = 1e-3
SHAPE = (1, 32, 32, 3)
# not a -backbone: the factories build SPPNetMono on the MobileNetV2 encoder
# for it, as the JAX package's does
MOBILENETV2 = "mobilenetv2"


def _images(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0.0, 1.0, shape).astype(np.float32) for _ in range(2))


def _worst(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    return max((np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max(), k) for k in ref)


def compare_module(jax_model, port, left, right):
    """Both models on the pre-processed views, every head they return
    post-processed: (JAX heads, port heads) as numpy."""
    jl, jr, hw = jdl.deeplab_preprocess(jnp.asarray(left), jnp.asarray(right))
    variables = variables_from_port(
        port, lambda k, a, b: jax_model.init({"params": k}, a, b, train=False),
        jax.random.PRNGKey(0), jl, jr)
    ref = jax.jit(lambda v, a, b: {k: jdl.deeplab_postprocess(o, hw) for k, o in
                                   jax_model.apply(v, a, b, train=False).items() if o is not None})(
        variables, jl, jr)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    tl, tr, _ = tdl.deeplab_preprocess(torch.from_numpy(left), torch.from_numpy(right))
    with torch.inference_mode():
        got = {k: tdl.deeplab_postprocess(o, hw) for k, o in port(tl, tr).items() if o is not None}
    return ({k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("name", ["deeplab", "deeplab_mobilenetv2", "deeplab_mod"])
def test_deeplab_matches_jax(name):
    left, right = _images()
    if name == "deeplab_mobilenetv2":
        jax_model = jdl.SPPNetMono(labels=2, enc_type=MOBILENETV2)
        port = tdl.SPPNetMono(labels=2, enc_type=MOBILENETV2)
        tmodels.init_parameters(port, torch.Generator().manual_seed(0))
    else:
        jcfg, cfg = net_configs(name)
        jax_model, port = jmodels.get_network(jcfg), tmodels.get_network(cfg, device="cpu")
    ref, got = compare_module(jax_model, port.eval(), left, right)
    assert set(got) == ({"seg1"} if name != "deeplab_mod" else {"seg1", "seg2", "disp1", "disp2"})
    assert got["seg1"].shape == (1, 32, 32, 2)
    rel, key = _worst(ref, got)
    assert rel <= REL, (key, rel)


def test_deeplab_mod_runs_the_encoder_once_per_view_in_train_mode():
    _, cfg = net_configs("deeplab_mod")
    port = tmodels.get_network(cfg, device="cpu").train()
    left, right = (torch.from_numpy(a) for a in _images(1))
    tl, tr, _ = tdl.deeplab_preprocess(left, right)
    seen = {"enc": [], "dec": []}
    port.encoder.bn1.register_forward_pre_hook(lambda m, a: seen["enc"].append(a[0].detach().clone()))
    port.decoder.low_bn.register_forward_pre_hook(lambda m, a: seen["dec"].append(a[0].detach()))
    before = port_stats(port)
    out = port(tl, tr)
    assert len(seen["enc"]) == 2 and len(seen["dec"]) == 1
    for x, view in zip(seen["enc"], (tl, tr)):  # left, then right
        want = port.encoder.conv1(view.permute(0, 3, 1, 2)).detach()
        torch.testing.assert_close(x, want, rtol=1e-5, atol=1e-5)
    for name, bn, calls in (("encoder.bn1", port.encoder.bn1, seen["enc"]),
                            ("decoder.low_bn", port.decoder.low_bn, seen["dec"])):
        mean, var = (torch.from_numpy(before[f"{name}.running_{s}"]).float() for s in ("mean", "var"))
        for x in calls:
            mean = 0.9 * mean + 0.1 * x.mean(dim=(0, 2, 3))
            var = 0.9 * var + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-6)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_deeplab_trains_with_batchnorm_in_eval_mode():
    _, cfg = net_configs("deeplab")
    cfg.loss.losses = ("cross_entropy",)
    model = tmodels.get_network(cfg, device="cpu")
    before = copy.deepcopy(model.state_dict())
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, 1))
    rng = np.random.default_rng(2)
    left, right = _images(2)
    batch = {"left": torch.from_numpy(left), "right": torch.from_numpy(right),
             "seg": torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, SHAPE[:3])]),
             "disp": torch.from_numpy(rng.random(SHAPE[:3] + (1,), dtype=np.float32))}
    _, metrics = make_train_step(cfg, model, device="cpu")(state, batch)
    assert np.isfinite(metrics["loss"].item())
    bns = [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(not m.training for _, m in bns)
    after = model.state_dict()
    for n, m in bns:  # running statistics untouched, scale and bias trained
        assert torch.equal(after[f"{n}.running_mean"], before[f"{n}.running_mean"]), n
        assert torch.equal(after[f"{n}.running_var"], before[f"{n}.running_var"]), n
    grads = [m.weight.grad for _, m in bns]
    assert all(g is not None for g in grads) and any(g.abs().max() > 0 for g in grads)
    assert not torch.equal(after["encoder.bn1.weight"], before["encoder.bn1.weight"])


@pytest.fixture(scope="module")
def tta_pair():
    """The deeplab net in both packages with the same weights, and the JAX
    model's jitted forward (``make_forward_fn``, so pre- and
    post-processing), one compile per image shape for both cases below.
    The encoder is MobileNetV2: TTA is the same around either encoder, and
    an Xception-65 compile at each of the three shapes would cost ~25 s
    cold (the Xception forward is held above, and ``-tta 1`` runs on it
    through the eval CLI in ``test_torch_session.py``)."""
    jcfg, cfg = net_configs("deeplab", backbone=MOBILENETV2)
    port = tmodels.get_network(cfg, device="cpu")
    jax_model = jmodels.get_network(jcfg)
    left = jnp.zeros((1, 33, 33, 3))
    variables = variables_from_port(
        port, lambda k, a, b: jax_model.init({"params": k}, a, b, train=False),
        jax.random.PRNGKey(0), left, left)
    tmodels.load_jax_variables(port, variables["params"], variables["batch_stats"])
    forward = jax.jit(lambda b: jstep.make_forward_fn(jcfg, jax_model)(
        variables["params"], variables["batch_stats"], b, jax.random.PRNGKey(0), False)[1]["seg1"])
    return port, forward


@pytest.mark.parametrize("scales", [(), (0.75, 1.25)])
def test_eval_step_tta_matches_jax(tta_pair, scales):
    """The port's eval step with -tta 1 (and -tta_scales) against the JAX
    package's ``evaluation.tta`` over its post-processed forward, which is
    what the JAX ``make_eval_step`` runs for ``deeplab``."""
    port, forward = tta_pair
    _, cfg = net_configs("deeplab", backbone=MOBILENETV2)
    cfg.run.tta, cfg.run.tta_scales = True, scales
    cfg.loss.losses = ("cross_entropy",)
    rng = np.random.default_rng(3)
    left, right = _images(3)
    batch = {"left": left, "right": right,
             "seg": np.eye(2, dtype=np.float32)[rng.integers(0, 2, SHAPE[:3])],
             "disp": rng.random(SHAPE[:3] + (1,), dtype=np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jax_tta(lambda x: forward(dict(jbatch, left=x, right=x)), jbatch["left"],
                              scales=list(scales) or None))
    got, metrics = make_eval_step(cfg, port, device="cpu")(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.equal(got["seg1"], got["seg2"])
    assert np.abs(got["seg1"].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.isfinite(metrics["loss"].numpy()).all()


def test_tta_on_another_net_raises_the_jax_error():
    jcfg, cfg = net_configs("sdnet_mini_ext")
    cfg.run.tta = True
    with pytest.raises(ValueError, match="only applies to the mono deeplab net"):
        make_eval_step(cfg, torch.nn.Module(), device="cpu")
