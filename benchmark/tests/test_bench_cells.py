"""BENCHMARK.json against the benchmark's contract, and every configuration,
traffic file, mode, limit file and metric reader found by the names in it.
What a cell is expected to hold comes from its own files."""
import json
import re

import pytest

from benchmark import harness, yardstick

from .conftest import CELLS, SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
MODE_API = ("WINDOW", "BACKWARD", "FIRST", "NUMBERS", "FAULTS", "build", "reload", "warm_up",
            "dispatch", "keep", "keep_outputs", "readings", "calibration_readings", "reference",
            "compare")


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    checks = 2 + 14 * 24
    assert checks * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    perf = (harness.ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert f"| {m['layer']} |" in perf, "a layer is named as PERF.md's list of layers has it"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # every per-layer metric moves an end-to-end metric the cell reports
        assert m["moves"] in e2e
    mode = harness.mode_of(c)
    assert c.chips in (1, 4) and all(hasattr(mode, a) for a in MODE_API)
    assert c.limits and set(c.limits) <= set(mode.NUMBERS)
    assert all(0 < lim < float("inf") for lim in c.limits.values())
    for key in ("batch", "height", "width", "pool", "trace_iterations"):
        assert c.traffic[key] > 0
    work = next(w for w in SPEC["workloads"] if w["name"] == cell)
    conf = next(x for x in SPEC["configs"] if x["name"] == work["config"])
    assert c.config["reduced"] == conf["reduced"] and c.config["labels"] >= 2
    assert c.dtype in yardstick.PEAK_FLOPS


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_parses(config):
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core.config import (
        config_from_args)
    spec = json.loads((harness.ROOT / config["file"]).read_text())
    assert config["file"].startswith("benchmark/configs/") and spec["name"] == config["name"]
    assert spec["source"] == config["source"] and spec["reduced"] == config["reduced"]
    cfg = config_from_args(spec["argv"])
    assert cfg.parallel.bf16 == (spec["dtype"] == "bfloat16")
    assert cfg.data.n_labels == spec["labels"]
    control = config_from_args(spec["argv"] + spec["control_argv"])
    assert control != cfg  # the control is another path of the program


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    read = harness.reader(metric["name"])
    run = harness.Run(mode="serve", net="sdnet", labels=2, losses=["cross_entropy"], batch=1,
                      height=64, width=128)
    value = read(run)  # nothing measured: a reader returns nothing, never 0
    assert value is None or metric["name"] == "setup_s"
