"""The port's user path on the CPU, torch only: the CLI (``cli.train.main``)
trains the flagship with the trunk at ``reduced_depth()`` from the files of
a 4+3-image roses fixture of 64x128, at ``-b 2``, with the eval bucket at
72x136 (so ``pad_mask`` matters) and an eval every epoch.

* A run of ``-e 1`` resumed to ``-e 2`` equals an uninterrupted ``-e 2``:
  the same weights and BatchNorm statistics, optimizer state, step count
  and history, exactly.
* The checkpoint directory and its best copy follow the JAX package's rule
  (``model_id()``, ``meta_{epoch}.json``, ``best.json``, one
  ``model_best_IOU{x}_Derr{y}``), and ``max_to_keep`` keeps the newest.
* The eval CLI's mean±std summary is the same at ``-b 2`` and ``-b 3``
  (a padded tail either way) within 1e-5 relative in fp32.
* A reference ``.pth.tar``, ``-pretrained_path``, ``-multaskloss 1``,
  ``-hanet 1``, ``-net deeplab`` and ``-tta 1`` run through the eval CLI.
"""
import os

import numpy as np
import pytest
import torch
from torch_port import reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.cli import train as cli
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import config_from_args
from pmt_learning_for_semantic_segmentation_and_disparity_torch.data import make_roses_fixture
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
    CheckpointManager,
    Session,
    TrainState,
    build_optimizer,
)

BUCKET = (72, 136)
FLAGS = ("-net sdnet_mini_ext -backbone densenet -corrType 1dcorr -crop 32 64 -b 2 "
         "-loss cross_entropy lovasz_loss tversky_loss ohm_loss -output_activation linear "
         "-datasetName roses -show_results 0").split()


@pytest.fixture(scope="module")
def fixture_argv(tmp_path_factory):
    root = tmp_path_factory.mktemp("session")
    m = make_roses_fixture(str(root / "ds"), n_train=4, n_test=3, hw=(64, 128))
    flags = {"-colorL": "left", "-colorR": "right", "-seg": "seg", "-disp": "disp", "-inst": "inst"}
    argv = [a for flag, k in flags.items() for a in (flag, m[k])]
    argv += [a for flag, k in flags.items() for a in (flag + "_test", m[k + "_t"])]
    return root, argv + FLAGS


def run(argv):
    """``cli.train.main(argv, device="cpu")`` at reduced depth, with the
    test's eval bucket and an eval after every epoch."""
    def small(a):
        cfg = config_from_args(a)
        cfg.data.eval_shape = BUCKET
        cfg.data.num_workers = 2
        cfg.run.eval_every = 1
        return cfg

    with reduced_depth(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "config_from_args", small)
        return cli.main(argv, device="cpu")


@pytest.fixture(scope="module")
def runs(fixture_argv):
    root, argv = fixture_argv
    train = argv + ["-train", "1"]
    full = run(train + ["-e", "2", "-w_savePath", str(root / "full")])
    first = run(train + ["-e", "1", "-w_savePath", str(root / "first")])
    first_dir = os.path.join(str(root / "first"), first.cfg.model_id())
    resumed = run(train + ["-e", "2", "-w_savePath", str(root / "resumed"), "-load_weights", first_dir])
    return {"full": full, "first": first, "resumed": resumed, "first_dir": first_dir,
            "root": root, "argv": argv}


def _history(session):
    ckpt = os.path.join(session.cfg.run.save_path, session.cfg.model_id())
    return CheckpointManager(ckpt).load_meta()["history"]


def test_resume_equals_uninterrupted(runs):
    full, resumed = runs["full"].state, runs["resumed"].state
    assert full.step == resumed.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa, ob = full.optimizer.state_dict()["inner"], resumed.optimizer.state_dict()["inner"]
    assert oa["param_groups"] == ob["param_groups"] and set(oa["state"]) == set(ob["state"])
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    hist = _history(runs["full"])
    assert len(hist) == 2 and _history(runs["resumed"]) == hist
    assert _history(runs["first"]) == hist[:1]


def test_checkpoint_layout_follows_jax(runs):
    files = sorted(os.listdir(runs["first_dir"]))
    best = [f for f in files if f.startswith("model_best")]
    assert files == sorted(["0", "meta_0.json", "best.json"] + best) and len(best) == 1
    ev = _history(runs["first"])[0]
    assert best[0] == f"model_best_IOU{round(ev['miou2'], 4)}_Derr{round(ev['derr'], 4)}"
    assert os.path.exists(os.path.join(runs["first_dir"], best[0], "state.pt"))


def test_best_artifact_and_max_to_keep(tmp_path):
    torch.manual_seed(0)
    cfg = config_from_args([])
    state = TrainState.create(torch.nn.Linear(3, 2), build_optimizer(cfg.optim, cfg.model.net, 1))
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step, (iou, derr) in enumerate([(0.5, 0.02), (0.75, 0.01), (0.6, 0.5), (0.7, 0.1)]):
        state.model.weight.data.fill_(step)
        mgr.save(step, state, extra={"epoch": step}, val_iou=iou, val_derr=derr)
    names = sorted(os.listdir(tmp_path / "ck"))
    assert [n for n in names if n.isdigit()] == ["2", "3"]
    assert [n for n in names if "model_best" in n] == ["model_best_IOU0.75_Derr0.01"]
    assert mgr.load_meta()["epoch"] == 3
    state.model.weight.data.zero_()
    mgr.restore(state)
    assert torch.equal(state.model.weight, torch.full((2, 3), 3.0))
    again = CheckpointManager(str(tmp_path / "ck"))  # best.json is read back
    assert again.best_iou == 0.75


def test_eval_cli_is_batch_invariant(runs):
    argv = runs["argv"] + ["-train", "0", "-load_weights", runs["first_dir"]]
    summaries = [run(argv + ["-b", str(b)]).eval_summary for b in (2, 3)]
    assert set(summaries[0]) == set(summaries[1])
    for k, v in summaries[0].items():
        np.testing.assert_allclose(summaries[1][k], v, rtol=1e-5, atol=1e-8, err_msg=k)
    assert summaries[0]["disp_valid"] == 64 * 128  # each row's pixels, padding excluded


@pytest.mark.parametrize("extra", ["-net deeplab -tta 1", "-net deeplab"])
def test_formerly_unported_options_run_through_the_eval_cli(fixture_argv, extra):
    """``-tta 1`` (on the mono deeplab net, the only one it applies to) and
    ``-net deeplab``, which raised before those nets were ported, run through the
    eval CLI (Xception-65 at full depth) and give finite summaries; every
    row's seg heads are one (the mono net's head 2 mirrors head 1)."""
    root, argv = fixture_argv
    session = run(argv + ["-train", "0", "-w_savePath", str(root / "x")] + extra.split())
    rows = session.accumulator.rows
    assert len(rows) == 3 and all(np.isfinite(v) for v in session.eval_summary.values())
    assert all(r["pixel_acc1"] == r["pixel_acc2"] for r in rows)


@pytest.mark.parametrize("extra", ["-pretrained_path", "-load_weights", "-multaskloss 1", "-hanet 1"])
def test_ported_options_run_through_the_eval_cli(fixture_argv, tmp_path, extra):
    """The eval CLI with a torchvision densenet as ``-pretrained_path`` (the
    trunk's tensors are the file's), a reference ``.pth.tar`` (``module.``
    prefix, ``state_dict`` wrapper) as ``-load_weights`` (every tensor is
    the file's), ``-multaskloss 1`` (the loss columns are the per-row means
    of the Kendall terms) and ``-hanet 1``: finite summaries."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.utils import torch_import

    root, argv = fixture_argv
    argv = argv + ["-train", "0", "-w_savePath", str(root / "x")]
    with reduced_depth():
        source = models.get_network(config_from_args(argv), device="cpu", seed=7)
    if extra == "-pretrained_path":
        path = str(tmp_path / "densenet.pth")
        torch.save({"features." + k: v for k, v in source.features.backbone.state_dict().items()}, path)
        argv += [extra, path]
    elif extra == "-load_weights":
        path = str(tmp_path / "model.pth.tar")
        ref = torch_import.export_state_dict(
            source, torch_import.entries_for(config_from_args(argv), source))
        torch.save({"state_dict": {"module." + k: v for k, v in ref.items()}, "epoch": 3}, path)
        argv += [extra, path]
    else:
        argv += extra.split()
    session = run(argv)
    assert session.accumulator.rows and all(np.isfinite(v) for v in session.eval_summary.values())
    got, want = session.model.state_dict(), source.state_dict()
    if extra == "-pretrained_path":
        assert all(torch.equal(got[k], want[k]) for k in want if k.startswith("features.backbone."))
    if extra == "-load_weights":
        assert all(torch.equal(got[k], v) for k, v in want.items())
    if extra == "-multaskloss 1":
        rows = session.accumulator.rows
        assert all(r["loss"] == pytest.approx(r["loss_seg"] + r["loss_disp"]) for r in rows)


def test_session_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session(config_from_args([]))
