"""Overfit-to-convergence smoke: prove the port's training stack LEARNS.

The port's copy of the JAX package's ``tools/overfit_smoke.py``, with its
configuration unchanged: ``sdnet_mini`` trains on the synthetic ROSeS fixture
(8 training pairs of 96x160, 64x128 crops, batches of 8, Adam at 5e-3,
cross-entropy) until it memorizes the train set, then evaluates ON THE
TRAIN IMAGES (the five ``*_test`` manifests are the training ones): expect
mIoU(head 2) > 0.9. A wiring bug in the losses, the optimizer or the label
plumbing fails it even when every unit test passes.

Runs on the card; ``main(device="cpu")`` runs it on the CPU. ~40 steps.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.overfit_smoke

prints one JSON line with the JAX tool's keys. ``OVERFIT_EPOCHS`` (default
40) sets the epochs, and ``OVERFIT_BF16=1`` the ``-f16`` policy (fp32
weights, bf16 compute). At 40 epochs that eval swings seed to seed in both
packages, so ``chip_smoke.py`` holds ``batch_statistics_miou`` instead and
checks it against ``LabelFault``, a run that cannot learn.
"""
from __future__ import annotations

import copy
import json
import os
import tempfile

import torch

from ..core import PMTConfig
from ..data import apply_fixture_to_config, make_roses_fixture
from ..data.datasets import build_datasets, normalization_for
from ..data.pipeline import DataLoader
from ..metrics.segmetrics import mean_iou, seg_batch_metrics
from ..training import Session, make_forward_fn

GATE = 0.9  # mIoU(head 2) on the memorized images
# scripts/train_flagship.sh's model and loss flags
FLAGSHIP = {"net": "sdnet_mini_ext", "backbone": "densenet", "corr_type": "1dcorr",
            "output_activation": "linear"}
FLAGSHIP_LOSSES = ("cross_entropy", "lovasz_loss")


def overfit_config(root: str, epochs: int = 40, bf16: bool = False, seed: int = 0,
                   flagship: bool = False) -> PMTConfig:
    """The JAX tool's configuration, its fixture written under ``root``; at
    the init seed ``seed`` (the fixture's own stays 0), and with the
    flagship's model and losses (``FLAGSHIP``) where ``flagship``."""
    manifests = make_roses_fixture(os.path.join(root, "ds"), n_train=8, n_test=2, hw=(96, 160))
    cfg = PMTConfig()
    apply_fixture_to_config(cfg, manifests)
    # memorization check: evaluate ON the train images
    for k_test, k_train in (("color_l_test", "color_l"), ("color_r_test", "color_r"),
                            ("disp_test", "disp"), ("seg_test", "seg"), ("inst_test", "inst")):
        setattr(cfg.data, k_test, getattr(cfg.data, k_train))
    cfg.model.net = "sdnet_mini"
    cfg.model.output_activation = "linear"
    cfg.loss.losses = ("cross_entropy",)
    cfg.data.crop = (64, 128)
    cfg.data.eval_shape = (96, 160)
    cfg.data.num_workers = 2
    cfg.run.batch = 8
    cfg.run.epochs = epochs
    cfg.run.eval_every = epochs  # a single, final eval
    cfg.run.save_path = os.path.join(root, "results")
    cfg.optim.learning_rate = 5e-3  # overfit fast on 8 images
    cfg.parallel.bf16 = bf16
    cfg.run.seed = seed
    if flagship:
        for k, v in FLAGSHIP.items():
            setattr(cfg.model, k, v)
        cfg.loss.losses = FLAGSHIP_LOSSES
    return cfg


def last_row(session: Session) -> dict:
    """``session.fit()`` quietly; the history's last row: the final eval."""
    return session.fit(log=lambda *a, **k: None)[-1]


def batch_statistics_miou(session: Session) -> float:
    """mIoU(head 2) of ``session``'s weights on its eval pairs (at most
    ``cfg.run.batch``: the tool's 8) in one train-mode forward of a copy of
    its model, each BatchNorm normalising by that batch's own statistics.
    What the eval would read without its running statistics' lag behind
    the weights: ``chip_smoke.py`` holds it (``PERF.md`` section 6, the overfit gate)."""
    cfg, model = session.cfg, copy.deepcopy(session.model)
    norm = normalization_for(cfg.model.backbone, cfg.model.net)
    _, testset = build_datasets(cfg.data, cfg.model.output_activation, cfg.model.max_disp, norm,
                                train=cfg.run.train)
    rows = next(iter(DataLoader(testset, cfg.run.batch, shuffle=False, num_workers=0,
                                drop_last=False, bucket_hw=cfg.data.eval_shape, pad_batch=True)))
    batch = {k: torch.as_tensor(rows[k][:rows["valid"]]).to(session.device)
             for k in ("left", "right", "seg", "disp")}
    with torch.no_grad():
        out = make_forward_fn(cfg, model, session.device)(batch, True)
    conf = seg_batch_metrics(out["seg2"], batch["seg"], cfg.data.n_labels).confusion
    return mean_iou(conf.double().cpu().numpy())[0]


class LabelFault(Session):
    """The gate's negative control: a Session with a planted label-plumbing
    fault, each training batch's ``seg`` rolled by one pair along the batch.
    The loader shuffles every epoch, so each image trains on another's
    labels, a different one each epoch; a readout that passes this run
    cannot tell a port that learns from one that does not."""

    def init_state(self, steps_per_epoch: int = 1):
        state = super().init_state(steps_per_epoch)
        step = self._train_step
        self._train_step = lambda state, batch: step(state, {**batch, "seg": batch["seg"].roll(1, 0)})
        return state


def result(ev: dict, epochs: int) -> dict:
    """The JAX tool's output line."""
    return {
        "metric": "overfit_smoke_miou2",
        "value": round(float(ev["miou2"]), 4),
        "loss": round(float(ev["loss"]), 4),
        "epochs": epochs,
        "pass": bool(ev["miou2"] > GATE),
    }


def main(device=None) -> dict:
    tmp = tempfile.mkdtemp(prefix="overfit_")
    epochs = int(os.environ.get("OVERFIT_EPOCHS", "40"))
    cfg = overfit_config(tmp, epochs, bf16=os.environ.get("OVERFIT_BF16", "0") == "1")
    line = result(last_row(Session(cfg, device=device)), epochs)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
