"""Forward, losses, train step, per-row eval step and on-device metrics,
counterpart of the JAX package's ``training/step.py``, on one card or on the
ranks of a ``parallel.mesh.Mesh``.

The bf16 policy (``cfg.parallel.bf16``): fp32 master weights, bf16 compute,
fp32 outputs and losses. Every convolution weight is cast to bf16 for the
call (the cast is part of the autograd graph, so gradients reach the fp32
masters through it). BatchNorm differs from the JAX package, which casts its
scale, bias and running statistics to bf16 too: here it keeps them in fp32
and normalises the bf16 maps with them, so its running update lands in the
master buffers themselves.

The deeplab nets take pre-processed images (the left view scaled to [-1, 1],
both padded by one) and their heads are post-processed back to the input's
size; the mono ``deeplab``'s disparity heads and ``pspnet``'s seg heads are
the ground truth, detached (the JAX package's ``_model_inputs`` and
``_postprocess_outputs``). ``deeplab`` trains with every BatchNorm in eval
mode, its BatchNorm parameters still learning (``-freeze_bn`` zeroes their
gradients).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.func import functional_call

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..losses.disp import photo_consistency
from ..losses.dispatch import compose_disp_loss, compose_seg_loss
from ..losses.edge import balanced_edge_bce
from ..metrics.dispmetrics import disp_metrics
from ..metrics.segmetrics import seg_batch_metrics
from ..parallel.mesh import Mesh, all_reduce, fold_in, gather_rows, mesh_size
from ..utils.profiling import span
from .state import TrainState

def _is_bn(m: torch.nn.Module) -> bool:
    return isinstance(m, torch.nn.modules.batchnorm._BatchNorm)


def _bf16_weights(model: torch.nn.Module):
    """(name, parameter) of every parameter the bf16 policy casts: all but
    the BatchNorm ones and the multitask loss's log-variances."""
    return [(f"{mod_name}.{n}" if mod_name else n, p)
            for mod_name, m in model.named_modules() if not _is_bn(m)
            for n, p in m.named_parameters(recurse=False) if not n.startswith("log_var")]


def _model_images(cfg: PMTConfig, batch: Dict[str, torch.Tensor], device: torch.device):
    """The model's two images (the JAX package's ``_model_inputs``): under
    ``-edges`` each view carries the sample's sobel edge map as a fourth
    channel; the deeplab nets take them pre-processed."""
    left, right = batch["left"].to(device), batch["right"].to(device)
    if cfg.model.edges:
        edges = batch["edges"].to(device)
        left, right = torch.cat([left, edges], dim=-1), torch.cat([right, edges], dim=-1)
    if cfg.model.output_type in ("deeplab", "deeplab_mod"):
        from ..models.deeplab import deeplab_preprocess

        left, right, _ = deeplab_preprocess(left, right)
    return left, right


def _postprocess(cfg: PMTConfig, out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
    """The head fix-ups netForward applies after the model
    (torch_implementation.py:157-179; the JAX package's
    ``_postprocess_outputs``)."""
    ot = cfg.model.output_type
    if ot not in ("deeplab", "deeplab_mod", "pspnet"):
        return out
    out = dict(out)
    if ot in ("deeplab", "deeplab_mod"):
        from ..models.deeplab import deeplab_postprocess

        hw = tuple(batch["left"].shape[1:3])
        for k in ("seg1", "seg2", "disp1", "disp2"):
            if out.get(k) is not None:
                out[k] = deeplab_postprocess(out[k], hw)
    if ot == "deeplab":  # the mono net: the disparity heads are the ground truth
        out["disp1"] = out["disp2"] = batch["disp"].detach()
        out["seg2"] = out["seg1"]
    if ot == "pspnet":  # the disparity net: the seg heads are the ground truth
        out["seg1"] = out["seg2"] = batch["seg"][..., :cfg.data.n_labels].detach()
    return out


def _model_kwargs(cfg: PMTConfig, batch: Dict[str, torch.Tensor], device: torch.device,
                  bf16: bool) -> Dict[str, torch.Tensor]:
    """The model's keyword inputs by output type (netForward,
    torch_implementation.py:118-152; the JAX package's ``_model_inputs``):
    the ground truth for the multitask terms, the left image's gradient
    magnitude for the edge nets (``edgeOut``, not normalized), HANet's
    coordinate grids, the ground-truth disparity of ``dsnet_warp_disp``
    (``ThreeOutPutsDisp``)."""
    kwargs = {}
    if cfg.model.output_type in ("multitask", "ThreeOutPutsDisp"):
        disp = batch["disp"].to(device)
        kwargs["disp_gt"] = disp.to(torch.bfloat16) if bf16 else disp
    if cfg.model.output_type == "multitask":
        kwargs["seg_labels"] = batch["seg"].to(device).argmax(-1)
    if cfg.model.output_type == "edgeOut":
        from ..ops.edges import compute_grad_mag

        left_e = compute_grad_mag(batch["left"].to(device), normalize=False)
        kwargs["left_e"] = left_e.to(torch.bfloat16) if bf16 else left_e
    if cfg.model.hanet:
        from ..models.hanet import build_pos_grid

        kwargs["pos"] = build_pos_grid(*batch["left"].shape[1:3], device=device)
    return kwargs


def _set_train_mode(cfg: PMTConfig, model: torch.nn.Module, train: bool) -> None:
    """``model.train(train)``; with ``freeze_bn``, and always for the mono
    ``deeplab``, the BatchNorm layers stay in eval mode while dropout trains
    (the JAX package's ``bn_frozen``)."""
    model.train(train)
    if train and (cfg.optim.freeze_bn or cfg.model.output_type == "deeplab"):
        for m in model.modules():
            if _is_bn(m):
                m.eval()


def make_forward_fn(cfg: PMTConfig, model: torch.nn.Module,
                    device: Optional[Union[str, torch.device]] = None):
    """Returns ``forward(batch, train=False) -> outputs`` on ``device`` (the
    card by default; raises without one unless ``device="cpu"``; the model is
    moved there and set to eval mode).

    ``batch`` holds NHWC ``left``/``right`` images (and ``edges`` under
    ``-edges``; ``seg``/``disp`` for the multitask output type, whose terms
    ``mt`` the model computes; ``disp`` for ``dsnet_warp_disp`` and
    ``deeplab``, ``seg`` for ``pspnet``); the outputs are the model's dict
    of NHWC tensors in fp32, post-processed as ``_postprocess`` says.
    ``train=True`` runs the train-mode forward (batch statistics,
    running-stat updates, dropout)."""
    device = resolve_device(device)
    model.to(device).eval()
    bf16 = cfg.parallel.bf16
    cast = _bf16_weights(model) if bf16 else []

    def forward(batch: Dict[str, torch.Tensor], train: bool = False) -> Dict[str, torch.Tensor]:
        if model.training != train:
            _set_train_mode(cfg, model, train)
        left, right = _model_images(cfg, batch, device)
        kwargs = _model_kwargs(cfg, batch, device, bf16)
        if not bf16:
            with span("model"):
                out = model(left, right, **kwargs)
            return _postprocess(cfg, out, batch)
        weights = {n: p.to(torch.bfloat16) for n, p in cast}
        with span("model"):
            out = functional_call(model, weights,
                                  (left.to(torch.bfloat16), right.to(torch.bfloat16)), kwargs)
        out = {k: v if v is None else tuple(t.float() for t in v) if isinstance(v, tuple)
               else v.float() for k, v in out.items()}
        return _postprocess(cfg, out, batch)

    return forward


# output types whose head-2 loss mirrors head 1's, so only head 1 counts
# (the JAX package's ``_SINGLE_HEAD``, ``step.py:42``)
_SINGLE_HEAD = ("smallOutPair", "deeplab", "edgeOut", "pspnet")
# the output types of the warp nets whose seg3 (the third seg head) counts
# in the seg loss, and those whose disparity loss is the photo-consistency
# of warped_right (the L1 zeroed)
_THREE_OUT = ("ThreeOutPuts", "ThreeOutPutsDisp", "ThreeOutPutsDispConsist")
_PHOTO = ("smallOutWarp", "ThreeOutPutsDispConsist")
# the output types of the nets: the flagship family, the Ext_small nets and
# the dlab net (smallOutSeg, hanet, multitask), sdnet_mini (smallOutPair),
# sdnet and sdnetv2 (two_out), the edge nets (edgeOut), sdnet_seg
# (smallOutWarp), the warp nets (ThreeOutPuts*), the deeplab nets, pspnet
PORTED_OUTPUT_TYPES = ("smallOutSeg", "smallOutPair", "two_out", "hanet", "multitask", "edgeOut",
                       "smallOutWarp", *_THREE_OUT, "deeplab", "deeplab_mod", "pspnet")


def _split(generator: Optional[torch.Generator]):
    """Two generators for the two heads, seeded from ``generator``, as the
    JAX step splits its key (None: both heads draw from the default
    generator)."""
    if generator is None:
        return None, None
    seeds = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device)
    return tuple(torch.Generator(generator.device).manual_seed(int(s)) for s in seeds)


def _copy(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A generator in ``generator``'s state: the JAX step draws seg3's loss
    from head 2's key."""
    if generator is None:
        return None
    g = torch.Generator(generator.device)
    g.set_state(generator.get_state())
    return g


def make_losses_fn(cfg: PMTConfig):
    """Returns ``losses(out, batch, generator=None) -> (loss, logs)`` on the
    model's outputs (the JAX package's ``step.py:175-220``): head 1's cross
    entropy on seg1, head 2's configured stack on seg2 (not for the
    single-head output types, e.g. ``sdnet_mini``'s), head 1's loss on seg3
    too for the ``ThreeOutPuts*`` types, and the disparity stack on disp1,
    replaced by ``photo_consistency`` of ``warped_right`` against the left
    image for ``smallOutWarp`` and ``ThreeOutPutsDispConsist``; for the
    multitask output type, the means of the model's Kendall terms ``mt``;
    for ``edgeOut``, plus ``balanced_edge_bce`` of the edge head against the
    batch's ``edges``. ``dual_edge_reg`` draws from ``generator``, split per
    head (seg3's loss draws what head 2's does)."""
    ot = cfg.model.output_type
    if ot not in PORTED_OUTPUT_TYPES:
        raise ValueError(f"unknown output type {ot!r}: one of {PORTED_OUTPUT_TYPES}")
    d = cfg.data
    head1_loss = compose_seg_loss(["cross_entropy"], d.dataset_name, d.n_labels, cfg.loss.seg_weight)
    head2_loss = compose_seg_loss(cfg.loss.losses, d.dataset_name, d.n_labels, cfg.loss.seg_weight)
    disp_loss = compose_disp_loss(cfg.loss.losses, d.dataset_name, ot)
    two_heads = ot not in _SINGLE_HEAD

    def losses(out, batch, generator: Optional[torch.Generator] = None):
        seg = batch["seg"]
        if ot == "multitask":
            mt_d, mt_s1, mt_s2 = out["mt"]
            loss_seg = mt_s1.mean() + mt_s2.mean()
            loss_disp = mt_d.mean()
        else:
            g1, g2 = _split(generator)
            g3 = _copy(g2)
            loss_seg = head1_loss(out["seg1"], seg, g1)
            if two_heads:
                loss_seg = loss_seg + head2_loss(out["seg2"], seg, g2)
            if ot in _THREE_OUT and out.get("seg3") is not None:
                loss_seg = loss_seg + head1_loss(out["seg3"], seg, g3)
            loss_disp = disp_loss(batch["disp"], out["disp1"], batch.get("left"), seg)
            if ot in _PHOTO:  # the L1 zeroed, photo-consistency instead
                loss_disp = loss_disp * 0.0 + photo_consistency(out["warped_right"], batch["left"])
        loss = loss_seg + loss_disp
        if ot == "edgeOut" and out.get("edge") is not None:
            loss = loss + balanced_edge_bce(out["edge"], batch["edges"])
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
        with span("step.forward", allocated=True):
            out = forward(batch, train)
        with span("step.losses"):
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


# metrics summed over the ranks; the others are averaged (the JAX step's)
_SUM_METRICS = ("conf1", "conf2", "disp_err3px", "disp_valid")


def _reduce_over_mesh(mesh: Mesh, model: torch.nn.Module,
                      metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The JAX step's reductions over a mesh: the mean of the gradients and
    of the BatchNorm running statistics (which differ between ranks when
    BatchNorm is per-replica), in place, and the reduced metrics: the sum of
    ``_SUM_METRICS``, the mean of the others. One all-reduce per dtype for
    each of the three."""
    n = mesh_size(mesh)
    params = list(model.parameters())
    for p in params:
        if p.grad is None:  # the optimizer reads a missing gradient as zero
            p.grad = torch.zeros_like(p)
    stats = [b for name, b in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    all_reduce(mesh, [p.grad for p in params], mean=True)
    all_reduce(mesh, stats, mean=True)
    metrics = {k: v.clone() for k, v in metrics.items()}
    all_reduce(mesh, list(metrics.values()))
    return {k: v if k in _SUM_METRICS else v / n for k, v in metrics.items()}


def make_train_step(cfg: PMTConfig, model: torch.nn.Module,
                    device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
    """Returns ``step(state, batch) -> (state, metrics)``: the train-mode
    forward, the configured losses, the backward, the metrics
    (``compute_metrics`` plus the loss logs), ``freeze_bn`` and one optimizer
    update, on ``device`` (the card by default). ``state`` is updated in
    place and returned. Under a profiler each phase is a span
    (``utils/profiling.py``): ``step.forward``, ``step.losses``,
    ``step.backward``, ``step.metrics`` (``step.reduce`` under a mesh) and
    ``step.optimizer``, in that order, after the ``zero_grad`` that opens the
    step in a ``step.optimizer`` span of its own (it drops the last step's
    gradients, which a caller may read until then).

    With a ``mesh`` of several ranks, ``batch`` is this rank's slice of the
    global batch; each rank's forward draws from its own random stream (a
    seed from the shared stream with the rank's index folded in), and after
    the backward the gradients, BatchNorm statistics and metrics are reduced
    over the mesh as the JAX step reduces them (``_reduce_over_mesh``), so
    every replica applies the same update. No ``DistributedDataParallel``:
    the bf16 forward is a ``functional_call`` that never enters
    ``DDP.forward``, and DDP's buffer broadcast would give every rank rank
    0's statistics where the JAX package averages them."""
    loss_fn = make_loss_fn(cfg, model, device)
    device = resolve_device(device)
    if mesh is not None and mesh_size(mesh) == 1:
        mesh = None

    def forward_backward(batch):
        loss, (out, logs) = loss_fn(batch, True)
        with span("step.backward", allocated=True):
            loss.backward()
        return out, logs

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(device) for k, v in batch.items()}
        with span("step.optimizer"):
            state.optimizer.zero_grad()
        if mesh is None:
            out, logs = forward_backward(batch)
        else:
            seed = fold_in(int(torch.randint(2**62, ())), mesh.rank)
            with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
                torch.manual_seed(seed)
                out, logs = forward_backward(batch)
        with span("step.metrics"), torch.no_grad():
            metrics = compute_metrics(cfg, {k: v.detach() for k, v in out.items()
                                            if isinstance(v, torch.Tensor)}, batch)
            metrics.update({k: v.detach() for k, v in logs.items()})
            del out, logs  # the forward's graph goes with them: its teardown stays in the span
        if mesh is not None:
            with span("step.reduce"), torch.no_grad():
                metrics = _reduce_over_mesh(mesh, state.model, metrics)
        with span("step.optimizer"):
            if cfg.optim.freeze_bn:
                _zero_bn_grads(state.model)
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


def _eval_metrics_full(cfg: PMTConfig, out: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """compute_metrics + the head-1 P/R/F1/BF1 the reference's eval needs for
    its max-of-heads columns (test_model torch_implementation.py:497-506:
    max(pixelPrec), max(pixelRecall), max(pixelF1), max(pixelBF1)).
    pad_to_bucket spatial padding is masked out of every metric."""
    pm = batch.get("pad_mask")
    pm = pm[..., 0] if pm is not None else None
    m = compute_metrics(cfg, out, batch, pixel_mask=pm)
    m1 = seg_batch_metrics(out["seg1"], batch["seg"], cfg.data.n_labels, pm)
    m.update(prec1=m1.precision, recall1=m1.recall, f1_1=m1.f1, bf1_1=m1.branch_f1)
    return m


# outputs / batch keys read by the per-row eval metrics and losses
_EVAL_OUT_KEYS = ("seg1", "seg2", "seg3", "disp1", "disp2", "warped_right", "edge")
_EVAL_BATCH_KEYS = ("left", "right", "seg", "disp", "edges", "pad_mask")


def eval_rows(cfg: PMTConfig, losses, out: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-row metrics and losses (``losses`` from ``make_losses_fn``) of a
    batch's outputs: each row's are those of that row alone, stacked along a
    leading batch dimension. For the multitask output type the loss columns
    are the per-row means of the model's per-pixel Kendall terms, as in the
    JAX package (their batch mean is the training loss)."""
    multitask = cfg.model.output_type == "multitask"
    mt = out.get("mt")
    out = {k: out[k] for k in _EVAL_OUT_KEYS if out.get(k) is not None}
    batch = {k: batch[k] for k in _EVAL_BATCH_KEYS if k in batch}
    rows = []
    for r in range(batch["left"].shape[0]):
        o = {k: v[r:r + 1] for k, v in out.items()}
        b = {k: v[r:r + 1] for k, v in batch.items()}
        m = _eval_metrics_full(cfg, o, b)
        if not multitask:
            m.update(losses(o, b)[1])
        rows.append(m)
    metrics = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
    if multitask:
        n = len(rows)

        def rowmean(x):
            if x.dim() >= 1 and x.shape[0] == n:
                return x.reshape(n, -1).mean(dim=1)
            return x.mean().expand(n)

        mt_d, mt_s1, mt_s2 = mt
        metrics["loss_disp"] = rowmean(mt_d)
        metrics["loss_seg"] = rowmean(mt_s1) + rowmean(mt_s2)
        metrics["loss"] = metrics["loss_disp"] + metrics["loss_seg"]
    return metrics


def _cat_rows(rows):
    """The outputs of one-row forwards as one batch (``mt`` term by term)."""
    return {k: (tuple(torch.cat(t) for t in zip(*(o[k] for o in rows)))
                if isinstance(rows[0][k], tuple) else torch.cat([o[k] for o in rows]))
            for k in rows[0]}


def make_eval_step(cfg: PMTConfig, model: torch.nn.Module,
                   device: Optional[Union[str, torch.device]] = None, mesh: Optional[Mesh] = None):
    """Returns ``step(batch) -> (outputs, per-row metrics)`` on ``device``
    (the card by default), the JAX package's ``make_eval_step``.

    With a ``mesh`` of several ranks, ``batch`` is this rank's rows (none is
    allowed) and the outputs are theirs; the metrics are every rank's rows,
    gathered through the host in the global batch's row order, as CPU
    tensors on every rank.

    Every metric has the batch as its leading dimension: scalars become (B,),
    the confusion matrices (B,n,n). Each row's metrics and losses are those
    of that row alone (a plain loop over rows), with ``pad_mask`` keeping the
    bucket's padding out of them, so the host can keep the first ``valid``
    rows and treat each as one reference eval step (test_model with batch=1,
    torch_implementation.py:450-582). The forward runs one row at a time too,
    as the reference's test_model does: the card's convolutions pick other
    algorithms at other batch sizes, so under the bf16 policy a batched
    forward gives a row other rounding, and other metrics, at another ``-b``;
    one row at a time, a row's outputs do not depend on the batch it came in.
    ``slide_window`` 1 and 2 run the windows of ``tiled_inference`` over a
    row as one batched forward (not for the multitask output type, as in
    the JAX package). ``tta`` averages the mono ``deeplab``'s seg heads over
    a flip and ``tta_scales`` (``evaluation.tta``); any other net raises the
    JAX package's ``ValueError``."""
    if cfg.run.tta and cfg.model.output_type != "deeplab":
        raise ValueError("-tta 1 only applies to the mono deeplab net "
                         "(SegmentatorTTA, models_deeplab/tta.py)")
    if cfg.run.slide_window and (cfg.model.edges or cfg.model.output_type == "multitask"):
        raise ValueError("-slide_window tiling is defined for the plain stereo nets (the "
                         "reference gates it the same way, torch_implementation.py:119)")
    forward = make_forward_fn(cfg, model, device)
    losses = make_losses_fn(cfg)
    device = resolve_device(device)

    def forward_eval(batch):
        if not cfg.run.slide_window:
            out = forward(batch, False)
            if cfg.run.tta:
                from ..evaluation.tta import tta

                seg = tta(lambda x: forward(dict(batch, left=x, right=x), False)["seg1"],
                          batch["left"], scales=list(cfg.run.tta_scales) or None)
                out = dict(out, seg1=seg, seg2=seg)
            return out
        from ..evaluation.tiled import tiled_inference

        window, stride, soft = (((512, 512), (256, 256), True) if cfg.run.slide_window == 2
                                else ((256, 512), (128, 256), False))
        out = tiled_inference(lambda l, r: forward(dict(batch, left=l, right=r), False),
                              batch["left"], batch["right"], window=window, stride=stride,
                              softmax_seg=soft)
        out.pop("window_counts", None)
        out.setdefault("seg2", out["seg1"])
        out["disp2"] = out["disp1"]
        return out

    if mesh is not None and mesh_size(mesh) == 1:
        mesh = None

    @torch.no_grad()
    def step(batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(device) for k, v in batch.items() if isinstance(v, torch.Tensor)}
        rows = batch["left"].shape[0]
        out = _cat_rows([forward_eval({k: v[r:r + 1] for k, v in batch.items()})
                         for r in range(rows)]) if rows else {}
        metrics = eval_rows(cfg, losses, out, batch) if rows else None
        if mesh is None:
            return out, metrics
        local = {k: v.cpu().numpy() for k, v in metrics.items()} if rows else None
        return out, {k: torch.from_numpy(v) for k, v in gather_rows(mesh, local).items()}

    return step
