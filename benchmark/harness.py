"""One run of one cell of the benchmark: ``run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything about a cell is found by name: the cell in ``BENCHMARK.json``,
its configuration's file (the CLI flags the program's ``config_from_args``
reads), its traffic file ``traffic/<traffic>.json``, its limits
``limits/<cell>.json``, one reader ``metrics/<metric>.py`` a metric, and the
module that drives the program, ``modes/<mode>.py``, which the traffic file
names under ``mode`` (see ``modes/__init__.py``). A new cell, metric or way
of driving the program is a new file; nothing here names one.

A run:

1. set-up (``setup_s``, from the process's start): the benchmark's weights
   and the traffic's pool of batches from the seed, the program at the
   configuration with those weights (``mode.build``), and its warm-up
   (``mode.warm_up``), which runs every shape the window will;
2. the window: iterations back to back for ``--seconds``, each one call
   into the program (``mode.dispatch``) and a synchronize, cycling through
   the pool. With ``--trace 1``, iterations 1 to ``trace_iterations`` run
   under ``torch.profiler`` with the device's activity alone (what the
   device metrics read), and the next ``trace_iterations`` with the host's
   operations too (what names the idle gaps); both are read in memory after
   the window;
3. after it: the peak memory, the check that no JAX module is loaded, the
   program's state freed, then the comparison with the reference
   (``mode.reference``, ``mode.compare``) and the metrics; last, the check
   for JAX modules once more, before anything is printed.

The last stdout line is the result; the last stderr lines are the numbers
compared, each beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pmt_learning_for_semantic_segmentation_and_disparity_tpu")
DEVICE = "cuda"
UNTRACED_AFTER = 2  # iterations after the traced ones that the untraced readings skip


def process_start() -> float:
    """The wall-clock time this process started (``/proc``, 10 ms ticks); the
    time of this call where that cannot be read."""
    now = time.time()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def dtype(self) -> str:
        """The type the configuration serves and trains in."""
        return self.config["dtype"]

    def flag(self, name: str) -> str:
        argv = self.config["argv"]
        return argv[argv.index(name) + 1]

    def losses(self) -> List[str]:
        argv = self.config["argv"]
        if "-loss" not in argv:
            return ["cross_entropy"]
        out = []
        for a in argv[argv.index("-loss") + 1:]:
            if a.startswith("-"):
                break
            out.append(a)
        return out


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(name=name, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=[m for m in spec["end_to_end"] if name in m.get("workloads", [name])],
                per_layer=[m for m in spec["per_layer"] if name in m["workloads"]],
                limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()))


def reader(metric: str) -> Callable:
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}",
                                                  BENCH / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def mode_of(cell: Cell):
    """The module ``modes/<mode>.py`` that drives the program for ``cell``."""
    return importlib.import_module(f"{__package__ or 'benchmark'}.modes.{cell.mode}")


@dataclass
class Run:
    """What a run measured, as the readers see it."""
    mode: str
    net: str
    labels: int
    losses: List[str]
    batch: int
    height: int
    width: int
    dtype: str = "float32"
    setup_s: float = 0.0
    window_s: float = 0.0
    iterations: int = 0
    latency_s: List[float] = field(default_factory=list)
    dispatch_s: List[float] = field(default_factory=list)
    trace: object = None  # trace.Trace of a --trace 1 run
    traced: int = 0       # iterations 1..traced ran under the profiler
    backward: bool = False  # an iteration runs the backward (the model's operations count it)
    _flops: Optional[float] = None

    @property
    def untraced_latency_s(self) -> List[float]:
        return self.latency_s[self.traced + UNTRACED_AFTER:] if self.trace is not None else []

    @property
    def untraced_dispatch_s(self) -> List[float]:
        return self.dispatch_s[self.traced + UNTRACED_AFTER:] if self.trace is not None else []

    def corr_sites(self):
        from .reference import nets
        return nets.corr_sites(self.net, self.batch, self.height, self.width)

    def flops(self) -> float:
        if self._flops is None:
            from . import yardstick
            self._flops = yardstick.model_flops(self.net, self.labels, self.losses, self.batch,
                                                self.height, self.width, self.backward)
        return self._flops


@dataclass
class Program:
    """The program under test as a mode built it: its configuration, model,
    the call the window makes (``call``) and the state it threads through
    the calls (the TrainState of training; None where there is none)."""
    cfg: object
    model: object
    call: Callable
    state: object = None


def port(module: str):
    return importlib.import_module(f"{PORT}.{module}")


def build_model(cell: Cell, weights, device, argv_extra=()):
    """(cfg, model): the program's configuration from the cell's CLI flags
    (and ``argv_extra``) and its model from ``models.get_network``, holding
    ``weights`` in their dtype."""
    cfg = port("core.config").config_from_args(list(cell.config["argv"]) + list(argv_extra))
    model = port("models").get_network(cfg, device=device)
    model.to(floating_dtype(weights)).load_state_dict(weights)
    return cfg, model


def floating_dtype(tensors):
    return next(t.dtype for t in tensors.values() if t.is_floating_point())


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def inputs_of(cell: Cell, seed: int, device, dtype=None):
    """(weights, pool): what both the program and the reference are handed,
    from the seed; ``dtype`` casts them (float64 in the CPU tests)."""
    from . import check, inputs
    weights = inputs.weights(check.template(cell.flag("-net"), cell.config["labels"]), seed, device)
    pool = inputs.pool(cell.traffic, cell.config["labels"], seed, device)
    if dtype is not None:
        weights = {k: v.to(dtype) if v.is_floating_point() else v for k, v in weights.items()}
        pool = [{k: v.to(dtype) for k, v in b.items()} for b in pool]
    return weights, pool


def _profiler(device, host: bool):
    """A profiler of the device's activity, and of the host's operations too
    where ``host`` (or where the run has no CUDA device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else []
    if host or not activities:
        activities.insert(0, ProfilerActivity.CPU)
    return profile(activities=activities)


def window(mode, prog: Program, run: Run, pool, seconds: float, device, first: int,
           trace_iterations: int = 0, keep=()):
    """Iterations back to back until ``seconds`` have passed, from the pool's
    batch ``first`` on; returns (kept outputs by iteration, the profilers of
    the device-only and the host segments that ran)."""
    from torch.profiler import record_function

    k, kept, done, prof = trace_iterations, {}, [], None
    starts, stops = ((1, 1 + k), (1 + k, 1 + 2 * k)) if k else ((), ())
    keep = set(keep)
    with mode.WINDOW():
        t0 = time.perf_counter()
        n = 0
        while True:
            if n in starts:
                prof = _profiler(device, host=n > 1)
                prof.start()
            batch = pool[(first + n) % len(pool)]
            with record_function("bench.iteration"):
                ts = time.perf_counter()
                with record_function("bench.dispatch"):
                    out = mode.dispatch(prog, batch)
                td = time.perf_counter()
                if n in keep:
                    kept[n] = mode.keep_outputs(out)
                with record_function("bench.sync"):
                    sync(device)
                te = time.perf_counter()
            run.latency_s.append(te - ts)
            run.dispatch_s.append(td - ts)
            n += 1
            if prof is not None and n in stops:
                prof.stop()
                done.append(prof)
                prof = None
            if te - t0 >= seconds:
                break
    if prof is not None:
        prof.stop()
        done.append(prof)
    run.window_s, run.iterations = te - t0, n
    run.traced = min(n - 1, 2 * k) if k else 0
    return kept, done


def finite(x: float) -> float:
    """``x``, or the largest float where it is infinite or NaN (JSON has
    neither)."""
    return x if math.isfinite(x) else sys.float_info.max


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit_w(device) -> Optional[float]:
    import torch
    if torch.device(device).type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _trace_cost(run: Run, k: int) -> str:
    """Median ms of an iteration traced with the device alone, with the
    host's operations too, and untraced: the profiler's cost."""
    def ms(xs):
        return f"{statistics.median(xs) * 1e3:.2f}" if xs else "none"
    return (f"trace median ms: device-only {ms(run.latency_s[1:1 + k])} with-host "
            f"{ms(run.latency_s[1 + k:1 + 2 * k])} untraced {ms(run.untraced_latency_s)}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device=None,
             fault: Optional[Callable] = None, started: Optional[float] = None,
             dtype=None) -> dict:
    """One run; returns the result line's object. For the tests alone:
    ``fault`` wraps the program's call (``fault(call, mode)``), ``dtype``
    casts the weights and the batches (float64 on the CPU)."""
    import torch

    from . import trace as tracing

    device = DEVICE if device is None else device
    mode = mode_of(cell)
    started = time.time() if started is None else started
    phases = [("start", started), ("imports", time.time())]
    t = cell.traffic
    run = Run(mode=cell.mode, net=cell.flag("-net"), labels=cell.config["labels"],
              losses=cell.losses(), batch=t["batch"], height=t["height"], width=t["width"],
              dtype=cell.dtype, backward=mode.BACKWARD)
    weights, pool = inputs_of(cell, seed, device, dtype)
    sync(device)
    phases.append(("inputs", time.time()))
    prog = mode.build(cell, weights, device)
    sync(device)
    phases.append(("program", time.time()))
    if fault is not None:
        prog.call = fault(prog.call, cell.mode)
    warm = mode.warm_up(cell, prog, pool, weights)
    sync(device)
    phases.append(("warm-up", time.time()))
    run.setup_s = time.time() - started
    print("setup " + " ".join(f"{name} {now - before:.3f}s" for (_, before), (name, now)
                              in zip(phases, phases[1:])), file=sys.stderr, flush=True)

    k = t["trace_iterations"] if trace else 0
    kept, profs = window(mode, prog, run, pool, seconds, device, mode.FIRST, k,
                         mode.keep(cell, seed))
    sync(device)
    cuda = torch.device(device).type == "cuda"
    if hasattr(mode, "memory_peak_bytes"):  # a mode whose program spans several processes
        peak = mode.memory_peak_bytes(prog)
    else:
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark runs the port alone")
    if profs:
        n = run.iterations - 1  # iteration 0 runs untraced
        run.trace = tracing.reduce(profs, (min(k, n), min(k, max(0, n - k))))
        del profs
        print(_trace_cost(run, k), file=sys.stderr, flush=True)
    readings = mode.readings(cell, warm, kept)
    if hasattr(mode, "release"):  # ends what the mode started besides this process's state
        mode.release(prog)
    del prog, warm, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = mode.reference(cell, weights, pool, seed, device)
    values, failed = mode.compare(cell, readings, ref)
    checks = {k: {"value": finite(values[k]), "limit": lim} for k, lim in cell.limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.iterations, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak,
                         "power_limit_w": power_limit_w(device)}}
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = tracing.breakdown(run.trace)
    result["checks"] = checks
    return result


def emit(result: dict) -> int:
    """Prints the numbers compared (stderr) and the result line (stdout),
    unless a JAX module has been loaded by now: then nothing, and 3."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the benchmark runs the port alone; "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    port("models")  # the program must be there before anything is printed
    return emit(run_cell(cell, args.seed, args.seconds, bool(args.trace), started=started))
