"""Forward, losses, train step and on-device metrics, counterpart of the JAX
package's ``training/step.py`` (single device; the per-row eval step and the
mesh path are later slices).

The bf16 policy (``cfg.parallel.bf16``): fp32 master weights, bf16 compute,
fp32 outputs and losses. Every convolution weight is cast to bf16 for the
call (the cast is part of the autograd graph, so gradients reach the fp32
masters through it). BatchNorm differs from the JAX package, which casts its
scale, bias and running statistics to bf16 too: here it keeps them in fp32
and normalises the bf16 maps with them, so its running update lands in the
master buffers themselves.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.func import functional_call

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..losses.dispatch import compose_disp_loss, compose_seg_loss
from ..metrics.dispmetrics import disp_metrics
from ..metrics.segmetrics import seg_batch_metrics
from .state import TrainState

def _is_bn(m: torch.nn.Module) -> bool:
    return isinstance(m, torch.nn.modules.batchnorm._BatchNorm)


def _bf16_weights(model: torch.nn.Module):
    """(name, parameter) of every parameter the bf16 policy casts: all but
    the BatchNorm ones."""
    return [(f"{mod_name}.{n}" if mod_name else n, p)
            for mod_name, m in model.named_modules() if not _is_bn(m)
            for n, p in m.named_parameters(recurse=False)]


def _set_train_mode(cfg: PMTConfig, model: torch.nn.Module, train: bool) -> None:
    """``model.train(train)``; with ``freeze_bn`` the BatchNorm layers stay in
    eval mode while dropout trains (the JAX package's ``bn_frozen``)."""
    model.train(train)
    if train and cfg.optim.freeze_bn:
        for m in model.modules():
            if _is_bn(m):
                m.eval()


def make_forward_fn(cfg: PMTConfig, model: torch.nn.Module,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns ``forward(batch, train=False) -> outputs`` on ``device`` (the
    card by default; raises without one unless ``device="cpu"``; the model is
    moved there and set to eval mode).

    ``batch`` holds NHWC ``left``/``right`` images; the outputs are the
    model's dict of NHWC tensors in fp32. ``train=True`` runs the train-mode
    forward (batch statistics, running-stat updates, dropout); the nets
    without one raise."""
    device = resolve_device(device)
    if cfg.model.edges:
        raise NotImplementedError("edge-input nets are not ported yet (ROADMAP.md queue 1, item 12.7)")
    model.to(device).eval()
    bf16 = cfg.parallel.bf16
    cast = _bf16_weights(model) if bf16 else []

    def forward(batch: Dict[str, torch.Tensor], train: bool = False) -> Dict[str, torch.Tensor]:
        if model.training != train:
            _set_train_mode(cfg, model, train)
        left = batch["left"].to(device)
        right = batch["right"].to(device)
        if not bf16:
            return model(left, right)
        weights = {n: p.to(torch.bfloat16) for n, p in cast}
        out = functional_call(model, weights, (left.to(torch.bfloat16), right.to(torch.bfloat16)))
        return {k: v.float() for k, v in out.items()}

    return forward


# output types whose head-2 loss mirrors head 1's, so only head 1 counts
# (the JAX package's ``_SINGLE_HEAD``, ``step.py:42``)
_SINGLE_HEAD = ("smallOutPair", "deeplab", "edgeOut", "pspnet")
# the output types of the ported nets: sdnet_mini_ext, sdnet_mini, sdnet and sdnetv2
PORTED_OUTPUT_TYPES = ("smallOutSeg", "smallOutPair", "two_out")


def _unported_output_type(ot: str) -> str:
    item = "12.4" if ot == "hanet" else "12.7"
    return f"the losses of output type {ot!r} are not ported yet (ROADMAP.md queue 1, item {item})"


def make_losses_fn(cfg: PMTConfig):
    """Returns ``losses(out, batch) -> (loss, logs)`` on the model's outputs:
    head 1's cross entropy on seg1, head 2's configured stack on seg2 (not
    for the single-head output types, e.g. ``sdnet_mini``'s), and the masked
    L1 on disp1 (the JAX package's ``step.py:175-220``, for the output types
    of the ported nets; any other raises)."""
    ot = cfg.model.output_type
    if ot not in PORTED_OUTPUT_TYPES:
        raise NotImplementedError(_unported_output_type(ot))
    d = cfg.data
    head1_loss = compose_seg_loss(["cross_entropy"], d.dataset_name, d.n_labels, cfg.loss.seg_weight)
    head2_loss = compose_seg_loss(cfg.loss.losses, d.dataset_name, d.n_labels, cfg.loss.seg_weight)
    disp_loss = compose_disp_loss(cfg.loss.losses, d.dataset_name, ot)
    two_heads = ot not in _SINGLE_HEAD

    def losses(out, batch):
        seg = batch["seg"]
        loss_seg = head1_loss(out["seg1"], seg)
        if two_heads:
            loss_seg = loss_seg + head2_loss(out["seg2"], seg)
        loss_disp = disp_loss(batch["disp"], out["disp1"])
        loss = loss_seg + loss_disp
        return loss, {"loss": loss, "loss_seg": loss_seg, "loss_disp": loss_disp}

    return losses


def make_loss_fn(cfg: PMTConfig, model: torch.nn.Module,
                 device: Optional[Union[str, torch.device]] = None):
    """Returns ``loss_fn(batch, train=True) -> (loss, (outputs, logs))`` on
    ``device`` (the card by default; the batch is moved there)."""
    forward = make_forward_fn(cfg, model, device)
    losses = make_losses_fn(cfg)
    device = resolve_device(device)

    def loss_fn(batch, train: bool = True):
        batch = {k: v.to(device) for k, v in batch.items()}
        out = forward(batch, train)
        loss, logs = losses(out, batch)
        return loss, (out, logs)

    return loss_fn


def _zero_bn_grads(model: torch.nn.Module) -> None:
    """``freeze_bn``: zero the gradients of the BatchNorm parameters."""
    for m in model.modules():
        if _is_bn(m):
            for p in m.parameters(recurse=False):
                if p.grad is not None:
                    p.grad.zero_()


def make_train_step(cfg: PMTConfig, model: torch.nn.Module,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch) -> (state, metrics)``: the train-mode
    forward, the configured losses, the backward, ``freeze_bn``, one
    optimizer update and the metrics (``compute_metrics`` plus the loss
    logs), on ``device`` (the card by default). ``state`` is updated in place
    and returned."""
    loss_fn = make_loss_fn(cfg, model, device)
    device = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(device) for k, v in batch.items()}
        state.optimizer.zero_grad()
        loss, (out, logs) = loss_fn(batch, True)
        loss.backward()
        if cfg.optim.freeze_bn:
            _zero_bn_grads(state.model)
        with torch.no_grad():
            metrics = compute_metrics(cfg, {k: v.detach() for k, v in out.items()}, batch)
            metrics.update({k: v.detach() for k, v in logs.items()})
        return state.apply_gradients(), metrics

    return step


def compute_metrics(cfg: PMTConfig, out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                    pixel_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """On-device metric pack for both heads + disparity."""
    n = cfg.data.n_labels
    m1 = seg_batch_metrics(out["seg1"], batch["seg"], n, pixel_mask)
    m2 = seg_batch_metrics(out["seg2"], batch["seg"], n, pixel_mask)
    use_mask = cfg.data.dataset_name not in ("garden", "roses")
    dm = disp_metrics(out["disp1"], batch["disp"], batch["seg"], cfg.model.max_disp,
                      mask_invalid=use_mask, pixel_mask=pixel_mask)
    return {
        "pixel_acc1": m1.pixel_acc, "pixel_acc2": m2.pixel_acc,
        "conf1": m1.confusion, "conf2": m2.confusion,
        "prec2": m2.precision, "recall2": m2.recall,
        "f1_2": m2.f1, "bf1_2": m2.branch_f1,
        "disp_err3px": dm.err_gt3px, "disp_valid": dm.valid_px,
        "disp_rmse": dm.rmse, "disp_sqrel": dm.sq_rel,
        "disp_brmse": dm.branch_rmse, "disp_bsqrel": dm.branch_sq_rel,
    }
