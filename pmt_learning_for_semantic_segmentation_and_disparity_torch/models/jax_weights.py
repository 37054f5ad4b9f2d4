"""Carry a flax variable tree of the JAX package into the port's modules.

The port's child names follow the flax module names, so a flax leaf at
``a/b/c/<leaf>`` fills the port's ``a.b.c.<name>``:

    params/.../kernel  (kh,kw,I,O)  -> weight (O,I,kh,kw), transpose(3,2,0,1)
    params/.../scale                -> weight          (BatchNorm)
    params/.../bias                 -> bias            (BatchNorm)
    batch_stats/.../mean            -> running_mean
    batch_stats/.../var             -> running_var

A flax ``nn.ConvTranspose`` kernel (the stride-2 ``DeconvBN`` of the legacy
nets) is also (kh,kw,I,O) and lands in the same (O,I,kh,kw) layout:
``blocks.SameConvTranspose2d`` keeps its weight as a conv's and transposes
and flips it for ``conv_transpose2d`` itself. (torch's ``ConvTranspose2d``
layout (I,O,kh,kw) would load a square 32->32 kernel without a shape error
and compute another function.)

The JAX package's variables are the same with ``s2d_heads`` on or off
(``PhaseBatchNorm`` owns the plain (C,) variables), so either model's tree
loads. Takes plain nested dicts of numpy arrays; imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_name(path: Tuple[str, ...], leaves: Dict[str, str]) -> str:
    if path[-1] not in leaves:
        raise KeyError(f"unknown flax leaf {'/'.join(path)}")
    return ".".join(path[:-1] + (leaves[path[-1]],))


@torch.no_grad()
def load_jax_variables(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> nn.Module:
    """Copy ``params`` and ``batch_stats`` (flax nested dicts of arrays) into
    ``model`` in place. Every flax leaf must fill exactly one port tensor and
    every port parameter and BatchNorm running statistic must be filled;
    raises ``KeyError`` on a leftover on either side and ``ValueError`` on a
    shape mismatch. (``num_batches_tracked`` has no flax counterpart and is
    left as it is.)"""
    targets = dict(model.named_parameters())
    targets.update((n, b) for n, b in model.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    filled = set()
    for tree, leaves in ((params, _PARAM_LEAVES), (batch_stats, _STAT_LEAVES)):
        for path, value in _flatten(tree):
            name = _port_name(path, leaves)
            if name not in targets:
                raise KeyError(f"flax leaf {'/'.join(path)} has no port tensor {name!r}")
            if name in filled:
                raise KeyError(f"port tensor {name!r} filled twice")
            value = np.array(value, dtype=np.float32)
            if value.ndim == 4:
                value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))  # HWIO -> OIHW
            dst = targets[name]
            if tuple(value.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} does not fit "
                                 f"{name} {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(value))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{len(missing)} port tensors got no flax leaf, e.g. {missing[:5]}")
    return model
