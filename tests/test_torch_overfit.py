"""The port's learning gate (``..._torch/tools/overfit_smoke.py``) against the
JAX package's own (the root ``tools/overfit_smoke.py``), without a JAX
compile: both tools run with their ``Session`` replaced by a stub that
records the config and returns a one-row history. The configurations agree
field by field (manifest paths relative to each tool's temporary directory),
the fixtures they write decode to equal arrays, and both print the same line
for the same final eval. Then the port's tool trains for real on the CPU, at
reduced depth for 2 epochs, its held readout leaves the model's running
statistics as they were, its negative control rolls each training batch's
labels, and it refuses to run without a card unless asked for the CPU. The
full run (40 epochs at full depth) is ``chip_smoke.py``'s phase 15 on the
card.
"""
import dataclasses
import importlib.util
import json
import math
import os
import tempfile
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
from torch_port import reduced_depth, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch.tools import overfit_smoke as port_tool
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import training as jtraining

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_overfit_smoke", ROOT / "tools" / "overfit_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stubbed_run(monkeypatch, capsys, package: str, tmp: Path, miou2: float = 0.95):
    """One tool's ``main()`` with its ``Session`` stubbed and its temporary
    directory at ``tmp``; returns (the config it built, its printed line)."""
    seen = {}

    class Stub:
        def __init__(self, cfg, *args, **kwargs):
            seen["cfg"] = cfg

        def fit(self, log=print):
            return [{"miou2": miou2, "loss": 0.25}]

    tmp.mkdir()
    with monkeypatch.context() as mp:
        mp.setattr(tempfile, "mkdtemp", lambda *a, **k: str(tmp))
        if package == "jax":
            mp.setattr(jtraining, "Session", Stub)
            # the tool moves the compile cache; this worker keeps the suite's
            mp.setattr(jax.config, "update", lambda *a, **k: None)
            _jax_tool().main()
        else:
            mp.setattr(port_tool, "Session", Stub)
            port_tool.main()
    return seen["cfg"], json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _fields(cfg, tmp: Path) -> dict:
    """{(section, field): value}, paths under ``tmp`` made relative to it."""
    out = {}
    for section, fields in dataclasses.asdict(cfg).items():
        for name, value in fields.items():
            if isinstance(value, str) and value.startswith(str(tmp)):
                value = os.path.relpath(value, tmp)
            out[(section, name)] = value
    return out


@pytest.fixture
def both(monkeypatch, capsys, tmp_path):
    monkeypatch.delenv("OVERFIT_EPOCHS", raising=False)
    monkeypatch.delenv("OVERFIT_BF16", raising=False)
    return {p: (tmp_path / p, *_stubbed_run(monkeypatch, capsys, p, tmp_path / p)) for p in ("jax", "port")}


def test_configuration_matches_the_jax_tool(both):
    (jtmp, jcfg, _), (ptmp, pcfg, _) = both["jax"], both["port"]
    jax_fields, port_fields = _fields(jcfg, jtmp), _fields(pcfg, ptmp)
    only = sorted(set(jax_fields) ^ set(port_fields))
    assert not only, f"fields only one package has: {only}"
    differ = {k: (jax_fields[k], port_fields[k]) for k in jax_fields if jax_fields[k] != port_fields[k]}
    assert not differ, differ
    # the memorization check: evaluated on the training images
    assert pcfg.data.color_l_test == pcfg.data.color_l and pcfg.data.seg_test == pcfg.data.seg
    assert (pcfg.model.net, pcfg.run.epochs, pcfg.run.eval_every) == ("sdnet_mini", 40, 40)


def test_fixture_files_decode_equal(both):
    (jtmp, _, _), (ptmp, _, _) = both["jax"], both["port"]
    jax_files = sorted(p.relative_to(jtmp) for p in (jtmp / "ds").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(ptmp) for p in (ptmp / "ds").rglob("*") if p.is_file())
    assert jax_files == port_files and len(jax_files) > 40
    for rel in jax_files:
        if rel.suffix == ".png":
            a = cv2.imread(str(jtmp / rel), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(ptmp / rel), cv2.IMREAD_UNCHANGED)
            assert a is not None and a.dtype == b.dtype and np.array_equal(a, b), rel
        else:  # manifests: one path a line, each under its tool's directory
            lines = [[os.path.relpath(line, tmp) for line in (tmp / rel).read_text().split()]
                     for tmp in (jtmp, ptmp)]
            assert lines[0] == lines[1], rel


def test_output_line_matches_the_jax_tool(monkeypatch, capsys, tmp_path):
    monkeypatch.delenv("OVERFIT_EPOCHS", raising=False)
    for i, miou2 in enumerate((0.9, 0.9001)):
        jax_line = _stubbed_run(monkeypatch, capsys, "jax", tmp_path / f"jax{i}", miou2)[1]
        port_line = _stubbed_run(monkeypatch, capsys, "port", tmp_path / f"port{i}", miou2)[1]
        assert jax_line == port_line, (jax_line, port_line)
        assert list(port_line) == ["metric", "value", "loss", "epochs", "pass"]
        assert port_line["pass"] is (miou2 > 0.9)


def test_short_run_on_the_cpu_and_none_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("OVERFIT_EPOCHS", "2")
    monkeypatch.delenv("OVERFIT_BF16", raising=False)
    monkeypatch.setattr(tempfile, "mkdtemp", lambda *a, **k: str(tmp_path))
    with reduced_depth():
        line = port_tool.main(device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["epochs"] == 2 and math.isfinite(line["value"]) and math.isfinite(line["loss"])
    assert 0.0 <= line["value"] <= 1.0
    # the held readout reads a copy of the model: the running statistics stay
    cfg = port_tool.overfit_config(str(tmp_path / "readout"), epochs=1)
    session = port_tool.Session(cfg, device="cpu")
    with reduced_depth():
        session.init_state()
    before = {k: v.clone() for k, v in session.model.state_dict().items()}
    held = port_tool.batch_statistics_miou(session)
    assert 0.0 <= held <= 1.0
    assert all(torch.equal(before[k], v) for k, v in session.model.state_dict().items())
    # the negative control trains each image on the next one's labels
    seen = []
    monkeypatch.setattr(port_tool.Session, "init_state",
                        lambda self, steps_per_epoch=1: setattr(self, "_train_step", lambda s, b: seen.append(b)))
    control = port_tool.LabelFault(cfg, device="cpu")
    control.init_state()
    seg = torch.arange(8).view(8, 1)
    control._train_step(None, {"left": seg, "seg": seg})
    assert torch.equal(seen[0]["seg"].flatten(), torch.tensor([7, 0, 1, 2, 3, 4, 5, 6]))
    assert seen[0]["left"] is seg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool.main()
