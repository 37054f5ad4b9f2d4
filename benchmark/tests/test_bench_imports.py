"""What a run and the reference load: a run on the CPU at a tiny size
loads no module whose top-level name is jax, jaxlib, flax or the JAX
package's, and a run in which anything loads one before the result is
printed prints none; the reference and the yardstick load nothing of the
program; and ``run.py`` prints no result without a card, or without the
program."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

PORT_TOP = harness.PORT
TINY = ("cell.traffic.update(batch=1, height=64, width=128, samples=1, sample_within=1, "
        "trace_iterations=1)")


def python(code, cwd=harness.ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_a_run_loads_no_jax():
    code = f"""
import sys, torch
torch.set_num_threads(2)
from benchmark import harness
cell = harness.load_cell("flagship-fp32.serve-b8")
{TINY}
harness.run_cell(cell, 2**40 + 3, 0.5, True, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}} & set(harness.FORBIDDEN)))
print(any(m.split(".")[0] == harness.PORT for m in sys.modules))
"""
    out = python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    forbidden, port = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]" and port == "True"


@pytest.mark.parametrize("planted", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, planted):
    """``main`` on the CPU (the card's look answered yes), its readers run
    after the window's own check; one of them loads a module named jax."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    code = f"""
import sys, torch
sys.path.insert(0, {str(tmp_path)!r})
torch.set_num_threads(2)
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from benchmark import harness
harness.DEVICE = "cpu"
load, read = harness.load_cell, harness.reader

def small(name):
    cell = load(name)
    {TINY}
    return cell

def planted(name):
    def reader(run):
        import jax  # noqa: F401
        return read(name)(run)
    return reader

harness.load_cell = small
if {planted!r}:
    harness.reader = planted
sys.exit(harness.main(["--workload", "flagship-fp32.serve-b8", "--seed", "5", "--seconds", "0.5",
                       "--trace", "0"]))
"""
    out = python(code)
    if planted:
        assert out.returncode != 0 and out.stdout == "", out.stdout[-2000:]
        assert "['jax']" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_forbidden_names_are_compared_whole():
    sys.modules["jaxtyping_lookalike"] = sys.modules["json"]
    try:
        assert "jaxtyping_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxtyping_lookalike"]


def test_reference_loads_nothing_of_the_program():
    code = """
import sys
import benchmark.reference.nets, benchmark.reference.losses, benchmark.reference.adam
import benchmark.check, benchmark.yardstick, benchmark.inputs, benchmark.trace
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"%s", "jax", "jaxlib", "flax", "%s"}))
""" % (PORT_TOP, harness.FORBIDDEN[-1])
    out = python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sdnet-fp32.serve-b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ["benchmark/run.py", "--workload", "sdnet-fp32.serve-b8", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
runpy.run_path("benchmark/run.py", run_name="__main__")
"""
    out = python(code, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "ModuleNotFoundError" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
