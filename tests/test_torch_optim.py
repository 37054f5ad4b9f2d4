"""The port's optimizer (``training/optim.py``) against optax as the JAX
package builds it (``training/optim.py:build_optimizer``): four steps on a
small parameter tree from the same start and the same gradients, fp32.
Bound: 1e-6 * max|param| per tensor after every step (optax and torch order
the Adam update's operations differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port import torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import OptimConfig
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import build_optimizer
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import OptimConfig as JaxOptim
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training.optim import (
    build_optimizer as jax_build_optimizer,
)

SHAPES = {"conv": (8, 4, 3, 3), "bn_scale": (8,), "bias": (5,)}
STEPS = 4

CASES = {
    "adam-2-losses": (dict(), 2),
    "adam-4-losses": (dict(), 4),
    "sgd-poly": (dict(optim_type="sgd", poly_epoch_horizon=2), 3),
    "adam-accumulate-2": (dict(accumulate_grad=2), 4),
    "sgd-accumulate-2": (dict(optim_type="sgd", accumulate_grad=2, poly_epoch_horizon=1), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    fields, n_losses = CASES[case]
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    jcfg, tcfg = JaxOptim(**fields), OptimConfig(**fields)
    assert tcfg.resolve_lr("sdnet_mini_ext", n_losses) == jcfg.resolve_lr("sdnet_mini_ext", n_losses)
    tx = jax_build_optimizer(jcfg, "sdnet_mini_ext", n_losses, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = build_optimizer(tcfg, "sdnet_mini_ext", n_losses, steps_per_epoch=2).init(tp.values())
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tp.items():
            ref = np.asarray(jp[k])
            np.testing.assert_allclose(p.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # every case moved the parameters
    assert all(not np.array_equal(tp[k].numpy(), params[k]) for k in params)


def test_lr_rule():
    cfg = OptimConfig()
    assert cfg.resolve_lr("sdnet_mini_ext", 2) == 1.5e-3
    assert cfg.resolve_lr("sdnet_mini_ext", 4) == 5e-4
    assert cfg.resolve_lr("deeplab", 4) == 5e-6
    assert OptimConfig(optim_type="sgd").resolve_lr("sdnet_mini_ext", 4) == 0.005
    assert OptimConfig(learning_rate=0.1).resolve_lr("deeplab", 1) == 0.1
