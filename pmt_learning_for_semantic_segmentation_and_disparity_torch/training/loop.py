"""Session orchestrator — the runNetwork equivalent
(torch_implementation.py:621-964), the port's counterpart of the JAX
package's ``training/loop.py`` on one device.

datasets -> model -> optimizer -> restore -> epochs of train steps with
periodic per-row eval and checkpointing. The device is the card unless the
caller passes ``device="cpu"``. A torch reference checkpoint (``.pth``,
``.pth.tar``, ``.pt``) of any net restores through ``utils.torch_import``,
and ``-pretrained_path`` grafts a torchvision densenet121 or a
MobileNetV3-Large into the trunk, or an Xception-65 into the deeplab nets'
encoder. Not ported yet: several cards (ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch

from ..core.config import PMTConfig
from ..core.device import resolve_device
from ..data.datasets import build_datasets, normalization_for
from ..data.pipeline import DataLoader, prefetch_to_device
from ..models import get_network
from .checkpoint import CheckpointManager
from .optim import build_optimizer
from .state import TrainState
from .step import make_eval_step, make_train_step


def load_pretrained_backbone(cfg: PMTConfig, model: torch.nn.Module) -> None:
    """``-pretrained_path``: for the deeplab nets a bare Xception-65 into the
    encoder; otherwise a torchvision densenet121 state dict (or the
    reference's own densenet), or a MobileNetV3-Large in cuevhv's layout,
    into the model's trunk (the JAX package's ``init_state``,
    loop.py:159-190); every tensor of the encoder or trunk is replaced. Any
    other trunk raises, as in the JAX package."""
    from ..utils.torch_import import (
        block_config_of,
        import_densenet121,
        import_mobilenetv3_backbone,
        import_xception65_backbone,
        load_port_state,
        load_torch_state_dict,
    )

    if cfg.model.net in ("deeplab", "deeplab_mod"):
        sd = load_torch_state_dict(cfg.model.pretrained_path)
        load_port_state(model.encoder, import_xception65_backbone(sd, model.encoder))
        return
    backbone = cfg.model.backbone
    if backbone not in ("densenet", "mobilenet"):
        raise NotImplementedError(f"-pretrained_path is wired for densenet121 and "
                                  f"mobilenetv3-large, not {backbone} (as in the JAX package)")
    sd = load_torch_state_dict(cfg.model.pretrained_path)
    trunk = model.features.backbone
    tensors = (import_mobilenetv3_backbone(sd, trunk) if backbone == "mobilenet"
               else import_densenet121(sd, block_config_of(model)))
    load_port_state(trunk, tensors)


class Session:
    def __init__(self, cfg: PMTConfig, device: Optional[Union[str, torch.device]] = None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = None
        self.state = None
        self._train_step = None
        self._eval_step = None
        # host seconds over the session: each train step with its wait for
        # the loader (``step_s``) and that wait alone (``load_wait_s``), and
        # whole evaluations (batches, the rows they report, one forward each)
        self.timings = {"step_s": [], "load_wait_s": [], "eval_batches": 0, "eval_rows": 0,
                        "eval_s": 0.0}
        self.accumulator = self.eval_summary = None

    # -- init ---------------------------------------------------------------
    def init_state(self, steps_per_epoch: int = 1) -> TrainState:
        """The model with the port's seeded init (``-seed``), its optimizer
        and the train and eval steps. The port's init draws other weights
        than flax's at the same seed; weights cross from the JAX package only
        through ``models.load_jax_variables``."""
        cfg = self.cfg
        self.model = get_network(cfg, self.device, seed=cfg.run.seed)
        if cfg.model.pretrained_path:
            load_pretrained_backbone(cfg, self.model)
        tx = build_optimizer(cfg.optim, cfg.model.net, len(cfg.loss.losses), steps_per_epoch)
        self.state = TrainState.create(self.model, tx)
        self._train_step = make_train_step(cfg, self.model, self.device)
        self._eval_step = make_eval_step(cfg, self.model, self.device)
        return self.state

    # -- epochs ------------------------------------------------------------
    def train_epoch(self, loader: DataLoader, epoch: int, log=print):
        cfg = self.cfg
        loader.set_epoch(epoch)
        # the epoch's dropout stream, so a resumed run draws what an
        # uninterrupted one does
        torch.manual_seed(cfg.run.seed * 131071 + epoch)
        t0 = time.time()
        last = {}
        it = prefetch_to_device(loader, self.device)
        i = 0
        while True:
            t_wait = time.perf_counter()
            try:
                batch, _ = next(it)
            except StopIteration:
                break
            t_step = time.perf_counter()
            self.state, metrics = self._train_step(self.state, batch)
            last = metrics
            if i % cfg.run.log_every == 0:
                log(
                    f"[{epoch + 1}, {i + 1:5d} / {len(loader)}] "
                    f"loss: {float(metrics['loss']):.3f} "
                    f"PixelAcc: {float(metrics['pixel_acc2']):.3f} "
                    f"({time.time() - t0:.1f}s)"
                )
            self.timings["load_wait_s"].append(t_step - t_wait)
            self.timings["step_s"].append(time.perf_counter() - t_wait)
            i += 1
        t_sync = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in last.items()}
        if i:  # the card's tail of the last step
            self.timings["step_s"][-1] += time.perf_counter() - t_sync
        return out

    def evaluate(self, loader: DataLoader, log=print,
                 show_per_step: bool = False,
                 artifacts_dir: Optional[str] = None) -> Dict[str, float]:
        """test_model equivalent: per-step tabulate tables when
        show_per_step (torch_implementation.py:512-566), final mean±std, and
        optional artifact dumps (prediction jpgs + confusion heatmaps, which
        need cv2 and matplotlib)."""
        from ..evaluation.evaluator import (
            MetricAccumulator,
            dump_prediction_images,
            save_confusion_matrix_png,
        )

        acc = MetricAccumulator()
        img = 0
        t0 = time.perf_counter()
        for batch, extras in prefetch_to_device(loader, self.device):
            # keep only the `valid` rows — padded tail rows (pad_batch) never
            # reach the step or the report. Each row is one reference eval
            # step (test_model runs batch=1).
            valid = extras.get("valid")
            if valid is not None:  # explicit: valid=0 must NOT fall back
                batch = {k: v[:valid] for k, v in batch.items()}
            out, m = self._eval_step(batch)
            self.timings["eval_batches"] += 1
            # the eval step returns PER-ROW metrics (leading dim = batch)
            m = {k: v.cpu().numpy() for k, v in m.items()}
            for r in range(next(iter(m.values())).shape[0]):
                row = acc.update({k: v[r] for k, v in m.items()})
                if show_per_step:
                    log(acc.table(step_row=row))
                if artifacts_dir is not None:
                    dump_prediction_images(
                        artifacts_dir, img,
                        out["seg2"][r:r + 1].cpu().numpy(),
                        batch["seg"][r:r + 1].cpu().numpy(),
                        out["disp1"][r:r + 1].cpu().numpy(),
                        batch["disp"][r:r + 1].cpu().numpy(),
                    )
                img += 1
        self.timings["eval_rows"] += img
        self.timings["eval_s"] += time.perf_counter() - t0
        summary = acc.summary(class_names=self.cfg.data.class_names)
        if artifacts_dir is not None and acc.conf2 is not None:
            save_confusion_matrix_png(
                acc.conf2, self.cfg.data.class_names,
                f"{artifacts_dir}/confusion_head2.png",
            )
            save_confusion_matrix_png(
                acc.conf1, self.cfg.data.class_names,
                f"{artifacts_dir}/confusion_head1.png",
            )
        out = {}
        for k, v in summary.items():
            if k in ("pixel_acc_cm", "pixel_acc_class"):
                out["pixel_acc_cm2" if k == "pixel_acc_cm" else k] = v
            else:
                out[k] = v
        log(acc.final_table())
        # the last evaluation's rows (``accumulator.rows``) and summary
        self.accumulator, self.eval_summary = acc, out
        return out

    # -- full run ------------------------------------------------------------
    def fit(self, log=print):
        cfg = self.cfg
        norm = normalization_for(cfg.model.backbone, cfg.model.net)
        trainset, testset = build_datasets(
            cfg.data, cfg.model.output_activation, cfg.model.max_disp, norm,
            train=cfg.run.train,
        )
        train_loader = DataLoader(
            trainset, cfg.run.batch, shuffle=True,
            num_workers=cfg.data.num_workers, seed=cfg.run.seed,
        )
        if len(trainset) < cfg.run.batch:
            raise ValueError(
                f"training set has {len(trainset)} samples < batch "
                f"{cfg.run.batch} (drop_last leaves zero batches)"
            )
        test_loader = DataLoader(
            testset, min(cfg.run.batch, max(1, len(testset))), shuffle=False,
            num_workers=cfg.data.num_workers, drop_last=False,
            bucket_hw=cfg.data.eval_shape, pad_batch=True,
        )
        self.init_state(steps_per_epoch=len(train_loader))
        ckpt = CheckpointManager(f"{cfg.run.save_path}/{cfg.model_id()}")
        start_epoch, history = 0, []
        if cfg.run.load_weights:
            start_epoch, history = self.restore(cfg.run.load_weights)
            log(f"restored checkpoint; resuming at epoch {start_epoch}")
        for epoch in range(start_epoch, cfg.run.epochs):
            self.train_epoch(train_loader, epoch, log=log)
            if (epoch + 1) % cfg.run.eval_every == 0 or epoch == cfg.run.epochs - 1:
                ev = self.evaluate(test_loader, log=log)
                history.append(ev)
                ckpt.save(
                    epoch, self.state,
                    extra={"epoch": epoch, "eval": ev, "history": history,
                           "config": cfg.to_json()},
                    val_iou=ev.get("miou2", -1.0),
                    val_derr=ev.get("derr", 0.0),
                )
        return history

    def restore(self, ckpt_dir: str):
        """Resume from a checkpoint directory (the reference's
        load_checkpoint_and_params path, torch_implementation.py:865-872 +
        utilTorch_loadweight.py:6-115): full state + start epoch + metric
        history — or by-name partial params when the head layout changed
        (hanet / convDeconvOut / deeplab_mod trigger by-name loading in the
        reference, torch_implementation.py:865). A ``.pth``/``.pth.tar``/
        ``.pt`` path imports a torch reference checkpoint of the net
        (``utils.torch_import``), the migration path for reference-trained
        weights; the optimizer starts afresh at epoch 0."""
        cfg = self.cfg
        if ckpt_dir.endswith((".pth", ".pth.tar", ".pt")):
            from ..utils.torch_import import import_checkpoint

            import_checkpoint(cfg, self.model, ckpt_dir)
            return 0, []
        src = CheckpointManager(ckpt_dir)
        by_name = (cfg.model.hanet or bool(cfg.model.conv_deconv_out)
                   or cfg.model.net == "deeplab_mod")
        if by_name:
            self.state = src.restore_params_partial(self.state)
            return 0, []
        self.state = src.restore(self.state)
        meta = src.load_meta()
        return int(meta.get("epoch", -1)) + 1, list(meta.get("history", []))

