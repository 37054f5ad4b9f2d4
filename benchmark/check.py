"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) run in fp32 with TF32 off on the
same inputs and weights, once the program's state is freed.

Training (``TrainReadings``): the program's first three steps, which set-up
drives through the window's own step on the pool's first three batches, and
the reference's three steps on the same batches:

* ``loss_gap``: |L_prog - L_ref| / |L_ref| of the first step's loss
  (``loss_gap_3``, the largest over the three steps, is a reading only);
* ``grad_gap``: for the first gradient, the median over the parameters of
  |‖g_prog‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median
  parameter's ‖g_ref‖ (``grad_gap_worst``, the same by the worst parameter,
  is a reading only); the program's gradient is read back from Adam's first
  moment after one step (exp_avg / (1 - beta1));
* ``change_gap``: by the worst parameter, the same for the parameters'
  change over the three steps, read before the fourth; parameters whose
  reference gradient is under a thousandth of the median parameter's are
  left out (they move by round-off alone under Adam);
* ``change_med_gap``: the same gap of the change by the median parameter.
  Adam's step is the learning rate times a ratio of moments whose size
  rounding hardly moves, so this reads the update's scale: a learning rate,
  an eps or a bias correction that is off moves every parameter alike.

* ``out_l2``: the smallest, over seg1, disp1, seg2 and disp2 of the first
  step's train-mode forward as the step's own call into the model produced
  them (a forward hook during set-up's first step), of ‖prog - ref‖ /
  ‖ref‖: the number by which the program's bf16 policy (the control) parts
  from its fp32. The loss and the norms average rounding away; the backward,
  and the heads fed by most train-mode BatchNorm layers, scatter TF32's as
  far as bf16's (a reading only: ``out_gap``, the largest
  max|prog - ref| / max|ref| over the outputs).

Why the first step's loss and the median parameter (PERF.md §2): TF32's
rounding, which the configuration states, moves a few ill-conditioned
gradients (the pyramid's coarsest branches, BatchNorm of the first dense
blocks) by 20-55% and the later steps' losses by up to 5e-3, in the
reference run with TF32 as much as in the program.

Serving: ``out_gap``, the largest max|prog - ref| / max|ref| over seg1,
disp1, seg2 and disp2 of the sampled requests.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from .reference import adam as ref_adam
from .reference import fp32_exact
from .reference import losses as ref_losses
from .reference import nets

OUTPUTS = ("seg1", "disp1", "seg2", "disp2")
FIRST_STEPS = 3  # the program's steps in set-up that the check reads


@dataclass
class TrainReadings:
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]
    outputs: Dict[str, torch.Tensor]  # the first step's forward, NHWC, on the host


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    values = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, values))


def template(net: str, labels: int) -> Dict[str, torch.Tensor]:
    """The reference net's state_dict on the meta device: names and shapes."""
    with torch.device("meta"):
        return nets.build(net, labels).state_dict()


def program_first_steps(step, state, model, pool, weights):
    """(readings, state after step 3): the program's steps 1-3 on the pool's
    batches 0-2, through ``step``, the window's own call."""
    names = {id(p): n for n, p in model.named_parameters()}
    losses, grads, outputs = [], None, {}

    def keep(module, args, out):
        outputs.update({k: out[k].detach().cpu() for k in OUTPUTS})

    for i in range(FIRST_STEPS):
        hook = model.register_forward_hook(keep) if i == 0 else None
        state, metrics = step(state, pool[i])
        if hook is not None:
            hook.remove()
        losses.append(float(metrics["loss"]))
        if i == 0:  # a step that did not reach the optimizer left no moment: no gradient
            moments = state.optimizer.inner.state
            grads = _norms({names[id(p)]: moments[p]["exp_avg"] / (1 - ref_adam.BETA1)
                            if "exp_avg" in moments.get(p, {}) else torch.zeros_like(p)
                            for p in state.optimizer.params})
    change = _norms({n: p.detach() - weights[n] for n, p in model.named_parameters()})
    return TrainReadings(losses, grads, change, outputs), state


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


def reference_first_steps(net: str, labels: int, losses: Sequence[str], weights, pool,
                          device) -> TrainReadings:
    with fp32_exact():
        model = reference_net(net, labels, weights, device).train()
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        opt = ref_adam.Adam(params, ref_adam.learning_rate(losses))
        readings, grad_norms, outputs = [], None, None
        for i in range(FIRST_STEPS):
            for p in params.values():
                p.grad = None
            batch = pool[i]
            out = model(_nchw(batch["left"]), _nchw(batch["right"]))
            if i == 0:
                outputs = {k: out[k].detach().permute(0, 2, 3, 1).cpu() for k in OUTPUTS}
            loss = ref_losses.total(out, batch, losses)
            loss.backward()
            readings.append(loss.item())
            del out, loss
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            if i == 0:
                grad_norms = _norms(grads)
            opt.step(grads)
        change = _norms({n: p.detach() - start[n] for n, p in params.items()})
    return TrainReadings(readings, grad_norms, change, outputs)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str]):
    median = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], median) for n in names]


def compare_train(prog: TrainReadings, ref: TrainReadings) -> Dict[str, float]:
    """The numbers compared (``loss_gap``, ``grad_gap``, ``change_gap``,
    ``change_med_gap``, ``out_l2``) and the readings beside them."""
    names = sorted(ref.grad_norms)
    median_grad = statistics.median(ref.grad_norms.values())
    moving = [n for n in names if ref.grad_norms[n] >= 1e-3 * median_grad]
    losses = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    grads = _leaf_gaps(prog.grad_norms, ref.grad_norms, names)
    changes = _leaf_gaps(prog.change_norms, ref.change_norms, moving)
    return {
        "loss_gap": losses[0],
        "grad_gap": statistics.median(grads),
        "change_gap": max(changes),
        "change_med_gap": statistics.median(changes),
        "out_l2": out_l2(prog.outputs, ref.outputs),
        "out_gap": out_gap(prog.outputs, ref.outputs),
        "loss_gap_3": max(losses),
        "grad_gap_worst": max(grads),
        **{f"out_l2.{k}": out_l2(prog.outputs, ref.outputs, (k,)) for k in OUTPUTS},
    }


def reference_net(net: str, labels: int, weights, device) -> torch.nn.Module:
    """The reference net in eval mode with the benchmark's weights."""
    with torch.device("meta"):
        model = nets.build(net, labels)
    dtype = next(t.dtype for t in weights.values() if t.is_floating_point())
    model = model.to_empty(device=device).to(dtype).eval()
    model.load_state_dict(weights)
    return model


def reference_outputs(model: torch.nn.Module, batch) -> Dict[str, torch.Tensor]:
    """The reference's eval forward of one request, NHWC."""
    with fp32_exact(), torch.no_grad():
        out = model(_nchw(batch["left"]), _nchw(batch["right"]))
        return {k: out[k].permute(0, 2, 3, 1) for k in OUTPUTS}


def _shapes_agree(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> bool:
    return all(k in prog and prog[k].shape == ref[k].shape for k in OUTPUTS)


def out_l2(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           outputs: Sequence[str] = OUTPUTS) -> float:
    """The smallest ‖prog - ref‖ / ‖ref‖ over ``outputs``; infinite where an
    output is missing or has another shape."""
    if not _shapes_agree(prog, ref):
        return float("inf")
    return min(float((prog[k].to(ref[k].dtype) - ref[k]).norm() / ref[k].norm())
               for k in outputs)


def out_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The largest max|prog - ref| / max|ref| over the outputs; infinite
    where an output is missing or has another shape."""
    if not _shapes_agree(prog, ref):
        return float("inf")
    return max(float((prog[k].to(ref[k].dtype) - ref[k]).abs().max() / ref[k].abs().max())
               for k in OUTPUTS)
