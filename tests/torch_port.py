"""Helpers shared by the PyTorch port's parity tests (``test_torch_*.py``).

* ``reduced_depth()`` runs the densenet121 trunk at block config (2, 2, 2, 2)
  in both packages (the registry entry "densenet" of each), so a JAX
  reference of a whole net traces and compiles in seconds. Widths, heads,
  the pyramid, the weight mapping and the patch choice are those of the full
  net; full depth is held by the flagship's eval fixture and on the card.
* ``torch_threads`` caps torch's CPU threads for a test module: the suite
  runs several workers on one machine, each with its own thread pools.
* ``flax_to_port(tree)`` renames a flax tree (gradients or parameters) to the
  port's parameter names, kernels in the port's (O, I, kh, kw) layout.
* ``variables_from_port(port, init, *args)`` is the flax variable tree that
  ``init(*args)`` would make, filled with the port model's own weights (the
  JAX package's initialisers, drawn by ``get_network``): the shapes come from
  ``jax.eval_shape``, which traces ``init`` without compiling it (a flax
  init's compile is the costliest part of a reference on the CPU).
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.registry import (
    BACKBONES as TORCH_BACKBONES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.models import densenet as td
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core.registry import (
    BACKBONES as JAX_BACKBONES,
)
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.models import densenet as jd

REDUCED_BLOCKS = (2, 2, 2, 2)
TORCH_THREADS = 2


def _jax_reduced(axis_name=None, name=None):
    return jd.DenseNetFeatures(REDUCED_BLOCKS, 32, 64, axis_name=axis_name, name=name)


def _torch_reduced():
    return td.DenseNetFeatures(REDUCED_BLOCKS, 32, 64)


@contextlib.contextmanager
def reduced_depth():
    """Both packages build "densenet" at block config (2, 2, 2, 2) inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_BACKBONES._items, "densenet", _jax_reduced)
        mp.setitem(TORCH_BACKBONES._items, "densenet", _torch_reduced)
        yield


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def variables_from_port(port: torch.nn.Module, init, *args) -> dict:
    """{"params": ..., "batch_stats": ...} of numpy arrays shaped as
    ``init(*args)`` returns them, holding ``port``'s weights."""
    state = port.state_dict()

    def leaf(path, shape):
        keys = [k.key for k in path]
        names = _LEAVES if keys[0] == "params" else _STATS
        a = state[".".join(keys[1:-1] + [names[keys[-1]]])].detach().numpy()
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        assert a.shape == shape.shape, (keys, a.shape, shape.shape)
        return np.array(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, *args))


def flax_to_port(tree) -> dict:
    """{port parameter name: float64 numpy array} of a flax params tree."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + (k,))
            else:
                a = np.asarray(v, np.float64)
                out[".".join(path + (_LEAVES[k],))] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    walk(tree, ())
    return out

