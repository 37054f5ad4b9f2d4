"""The check against the program broken underneath: a whole run on the CPU
at a tiny size (every step of a run but the look for a card), in float64 so
that a sound run reads far under the cell's limits, sees ``correct`` come out
true, and false with each fault a cell of its mode can have (the mode's
``FAULTS``; the exchange between chips does not exist on one chip). Then the
control, the configuration's ``control_argv`` (the program's bf16 policy) in
fp32 at a small size, fails the committed limits too."""
import json

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.faults import FAULTS

from .conftest import cells, tiny

CASES = [(c, f) for c in cells() for f in (None,) + harness.mode_of(harness.load_cell(c)).FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_run_is_correct_unless_broken(name, fault):
    cell = tiny(harness.load_cell(name))
    result = harness.run_cell(cell, 2**33 + 5, 6.0, False, device="cpu",
                              fault=FAULTS[fault] if fault else None, dtype=torch.float64)
    values = {k: c["value"] for k, c in result["checks"].items()}
    assert result["correct"] is (fault is None), values
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    json.dumps(result, allow_nan=False)  # the line is strict JSON, faults and all


@pytest.mark.parametrize("name", cells())
def test_control_fails(name):
    cell = tiny(harness.load_cell(name))
    if cell.mode == "serve":  # outputs of 128x256: at 64x128 bf16 reads under the limit
        cell.traffic.update(height=128, width=256)
    rows = calibrate.calibrate(cell, [7], 1, "cpu")
    by = {r["variant"]: r for r in rows}
    over = [k for k, lim in cell.limits.items() if not by["control"][k] <= lim]
    assert over, by["control"]
