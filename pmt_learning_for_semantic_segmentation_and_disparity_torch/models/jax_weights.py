"""Carry a flax variable tree of the JAX package into the port's modules.

The port's child names follow the flax module names, so a flax leaf at
``a/b/c/<leaf>`` fills the port's ``a.b.c.<name>``:

    params/.../kernel  (kh,kw,I,O)  -> weight (O,I,kh,kw), transpose(3,2,0,1)
    params/.../kernel  (k,I,O)      -> weight (O,I,k), transpose(2,1,0) (Conv1d)
    params/.../kernel  (kd,kh,kw,I,O) -> weight (O,I,kd,kh,kw),
                                       transpose(4,3,0,1,2) (3-D convs)
    params/.../kernel  (I,O)        -> weight (O,I), transpose (nn.Dense ->
                                       nn.Linear)
    params/.../scale                -> weight          (BatchNorm)
    params/.../bias                 -> bias            (BatchNorm, Conv1d)
    params/.../embedding            -> weight          (nn.Embedding)
    params/<name>                   -> <name>          (a free parameter, e.g.
                                                        log_var_disp)
    batch_stats/.../mean            -> running_mean
    batch_stats/.../var             -> running_var

A flax ``nn.ConvTranspose`` kernel (the stride-2 ``DeconvBN`` of the legacy
nets, PSMNet's 3-D ``_Deconv3dBN``) is also (k..., I, O) and lands in the
same (O, I, k...) layout: ``blocks.SameConvTranspose2d``/``3d`` keep their
weight as a conv's and transpose and flip it for the transposed conv
themselves. (torch's ``ConvTranspose2d``
layout (I,O,kh,kw) would load a square 32->32 kernel without a shape error
and compute another function.) The same trap stands at a flax ``Dense``
(MobileNetV3's squeeze-excite): its (in, out) kernel fits a square
``nn.Linear`` weight (out, in) untransposed, so every 2-D kernel is
transposed.

The JAX package's variables are the same with ``s2d_heads`` on or off
(``PhaseBatchNorm`` owns the plain (C,) variables), so either model's tree
loads. Takes plain nested dicts of numpy arrays; imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_name(path: Tuple[str, ...], leaves: Dict[str, str], targets) -> str:
    if path[-1] in leaves:
        return ".".join(path[:-1] + (leaves[path[-1]],))
    if ".".join(path) in targets:  # a free parameter of a module
        return ".".join(path)
    raise KeyError(f"unknown flax leaf {'/'.join(path)}")


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
            name = _port_name(path, leaves, targets)
            if name not in targets:
                raise KeyError(f"flax leaf {'/'.join(path)} has no port tensor {name!r}")
            if name in filled:
                raise KeyError(f"port tensor {name!r} filled twice")
            value = np.array(value, dtype=np.float32)
            if value.ndim == 5:
                value = np.ascontiguousarray(value.transpose(4, 3, 0, 1, 2))  # DHWIO -> OIDHW
            elif value.ndim == 4:
                value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))  # HWIO -> OIHW
            elif value.ndim == 3:
                value = np.ascontiguousarray(value.transpose(2, 1, 0))  # (k, I, O) -> OIk
            elif value.ndim == 2 and path[-1] == "kernel":
                value = np.ascontiguousarray(value.T)  # Dense (I, O) -> Linear (O, I)
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
