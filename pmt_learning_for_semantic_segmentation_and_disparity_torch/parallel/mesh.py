"""Data-parallel ranks over ``torch.distributed``: the port's counterpart of
the JAX package's ``parallel/mesh.py``.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` of every
device; torch's model is one process per card. A ``Mesh`` here is one rank's
view of those processes: its index, its card, the group of the whole mesh,
the ``data`` group its gradients and BatchNorm statistics are averaged over,
and on a hierarchical ``(replica, data)`` mesh the ``replica`` group too.
Ranks are arranged replica-major, as the JAX package reshapes its devices,
so a rank's index is its flattened mesh index: the position of its slice in
the global batch and the index folded into its random stream.

``batch_sharding`` and ``replicated`` return ``NamedSharding``s in the JAX
package; they have no torch meaning and are not ported (ROADMAP.md queue 3,
item 4). Nothing here starts a process group at import.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

DATA_AXIS = "data"
REPLICA_AXIS = "replica"


def setup_distributed(backend: Optional[str] = None,
                      device: Optional[Union[str, torch.device]] = None,
                      coordinator: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> bool:
    """Join the process group of a multi-process run; returns whether more
    than one process runs.

    The rendezvous comes from the arguments, else from the JAX package's
    ``PMT_COORDINATOR`` (host:port) / ``PMT_NUM_PROCESSES`` /
    ``PMT_PROCESS_ID``, else from torchrun's ``WORLD_SIZE`` / ``RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` (its ``LOCAL_RANK`` picks the card:
    ``core.device.resolve_device``). With none of them, or one process,
    nothing is started; a group that exists is kept. The backend is NCCL on
    the card and gloo where the caller asks for the CPU (``device="cpu"``) or
    passes ``backend="gloo"`` (several ranks on one card, which NCCL
    refuses)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator = coordinator or env.get("PMT_COORDINATOR")
    if num_processes is None:
        n = env.get("PMT_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else 1
    if num_processes <= 1:
        return False
    if process_id is None:
        r = env.get("PMT_PROCESS_ID") or env.get("RANK")
        if not r:
            raise ValueError(f"{num_processes} processes but no rank: pass process_id or set "
                             "PMT_PROCESS_ID (torchrun sets RANK)")
        process_id = int(r)
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(resolve_device(device))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}" if coordinator else "env://",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel ranks: ``shape`` maps each axis
    (outermost first) to its size, ``rank`` is this process's flattened
    index (its rank in ``group``), ``device`` its card (or the CPU).
    ``group`` spans the mesh; ``data_group`` and ``replica_group`` are this
    rank's process groups along those axes. Each is None where it holds one
    rank."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    replica_group: Optional[dist.ProcessGroup] = None


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = (DATA_AXIS,),
              mesh_shape: Optional[Sequence[int]] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh of every rank of the process group (one rank without one), on
    ``device`` (this rank's card by default). ``mesh_shape=(n_rep, n_data)``
    builds the hierarchical ``('replica', 'data')`` mesh: ranks ``r * n_data
    ... (r + 1) * n_data - 1`` form replica ``r``'s data group, and ranks
    with the same index in their replica form a replica group. Every rank
    must call it with the same arguments. ``n_devices``, where given, must
    be the number of ranks: a rank cannot sit out."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = resolve_device(device)
    if mesh_shape is not None and len(mesh_shape) == 2:
        n_rep, n_data = mesh_shape
        if n_rep * n_data != world:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs {n_rep * n_data} ranks, "
                             f"have {world}")
        data = replica = None
        if n_data > 1:
            data, _ = dist.new_subgroups_by_enumeration(
                [list(range(r * n_data, (r + 1) * n_data)) for r in range(n_rep)])
        if n_rep > 1:
            replica, _ = dist.new_subgroups_by_enumeration(
                [list(range(d, world, n_data)) for d in range(n_data)])
        return Mesh({REPLICA_AXIS: n_rep, DATA_AXIS: n_data}, rank, device,
                    dist.group.WORLD if world > 1 else None, data, replica)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh(n_devices={n_devices}) in a group of {world} ranks: one "
                         f"process per card, every rank in the mesh")
    shape = {axes[0]: world, **{a: 1 for a in axes[1:]}}
    group = dist.group.WORLD if world > 1 else None
    return Mesh(shape, rank, device, group, group)


def mesh_size(mesh: Mesh) -> int:
    """Total data-parallel width (product of all mesh axes)."""
    return int(np.prod(list(mesh.shape.values())))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh_size(mesh)
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel size {n}"
        )
    return global_batch // n


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous slice of a global batch: rows ``rank * n ...
    (rank + 1) * n - 1`` of every array, tensor or list (``n`` the local
    batch); other values (``valid``) are kept."""
    rows = len(next(v for v in batch.values() if isinstance(v, (np.ndarray, torch.Tensor))))
    n = local_batch_size(rows, mesh)
    lo = mesh.rank * n
    return {k: v[lo:lo + n] if isinstance(v, (np.ndarray, torch.Tensor, list)) else v
            for k, v in batch.items()}


def _coalesced(mesh: Mesh, tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` in place on ``tensors`` packed into one flat
    buffer per dtype on the mesh's device (a host tensor, such as Adam's step
    count, makes the round trip: NCCL takes only the card's), and copy the
    results back."""
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in ts])
        collective(flat)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.detach().copy_(v.view_as(t))


def all_reduce(mesh: Mesh, tensors: List[torch.Tensor], mean: bool = False) -> None:
    """Sum (``mean``: average) each tensor over every rank, in place: one
    flat buffer per dtype, all-reduced over the ``data`` group, then over the
    ``replica`` group (the JAX step's order, innermost axis first)."""
    def reduce(flat):
        for group in (mesh.data_group, mesh.replica_group):
            if group is not None:
                dist.all_reduce(flat, group=group)
        if mean:
            flat.div_(mesh_size(mesh))

    _coalesced(mesh, tensors, reduce)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_with_grad(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose backward sums the gradient over
    the group too: every rank's loss depends on every rank's ``x``."""
    return _AllReduceSum.apply(x, group)


def replicate(mesh: Mesh, state):
    """Broadcast every tensor of ``state`` from the mesh's rank 0, in place,
    and return it: a ``TrainState`` (the model's parameters and buffers, the
    optimizer's moments, step counts and accumulated gradients) or a module.
    Replicas then start equal whatever each one drew or loaded."""
    if mesh_size(mesh) == 1:
        return state
    model = getattr(state, "model", state)
    tensors = list(model.parameters()) + list(model.buffers())
    optimizer = getattr(state, "optimizer", None)
    if optimizer is not None:
        tensors += [v for s in optimizer.inner.state.values() for v in s.values()
                    if isinstance(v, torch.Tensor)]
        tensors += list(optimizer.acc or [])
    src = dist.get_global_rank(mesh.group, 0)
    _coalesced(mesh, tensors, lambda flat: dist.broadcast(flat, src=src, group=mesh.group))
    return state


def gather_rows(mesh: Mesh, rows: Optional[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Every rank's per-row arrays (leading dimension: its rows; None: it has
    none) joined in rank order, which is the global batch's row order, on
    every rank. The rows travel through the host (``all_gather_object``)."""
    if mesh_size(mesh) == 1:
        return rows
    parts = [None] * mesh_size(mesh)
    dist.all_gather_object(parts, rows, group=mesh.group)
    parts = [p for p in parts if p is not None]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh."""
    if mesh_size(mesh) > 1:
        dist.barrier(group=mesh.group)


def fold_in(seed: int, index: int) -> int:
    """A seed for rank ``index`` from the shared ``seed`` (the counterpart of
    ``jax.random.fold_in``): distinct ranks draw independent streams."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
