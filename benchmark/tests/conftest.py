"""The benchmark's CPU tests: tiny shapes, torch capped at a few threads.
A test that needs the card carries the ``card`` marker and decides inside
itself, by ``needs_card()``, to skip without one. The cells, and what each
test expects of one, come from ``BENCHMARK.json`` and the cell's own files."""
import json

import pytest
import torch

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = dict(batch=2, height=64, width=128, samples=1, sample_within=1, trace_iterations=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def cells(mode=None):
    """The cells of BENCHMARK.json, those of one mode where it is given."""
    return [c for c in CELLS if mode is None or harness.load_cell(c).mode == mode]


def tiny(cell, **extra):
    """The cell at a size the CPU runs in seconds: its traffic's sizes that
    ``SMALL`` names, cut."""
    cell.traffic.update({k: v for k, v in SMALL.items() if k in cell.traffic}, **extra)
    return cell
