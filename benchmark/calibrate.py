"""The readings a cell's limits are set from, on the card at the cell's own
size (never run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 3] [--out FILE]

For each seed, the numbers the cell's mode compares (``modes/<mode>.py``),
against the reference on the same weights and batches, of

* ``sound``: the program as the configuration states it, through the same
  call a run makes (training: the first three steps; serving: the forward on
  the requests a run samples);
* ``control``: the program's own lower precision, the configuration's
  ``control_argv`` (the bf16 policy, ``-f16 1``), on the first
  ``--control-seeds`` seeds;
* each fault of the mode's ``FAULTS`` that needs a run (a state left
  unchanged reads 1 by the training measure and is not run), on the same
  seeds.

One program is resident at a time; the reference runs last, once a seed.
Prints one JSON line a reading and, with ``--out``, writes them all there.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def program_readings(cell, variant, seeds, device):
    """{seed: readings} of one variant: 'sound', 'control' or a fault."""
    mode = harness.mode_of(cell)
    extra = tuple(cell.config["control_argv"]) if variant == "control" else ()
    out, prog = {}, None
    for seed in seeds:
        weights, pool = harness.inputs_of(cell, seed, device)
        if prog is None:
            prog = mode.build(cell, weights, device, extra)
            if variant in FAULTS:
                prog.call = FAULTS[variant](prog.call, cell.mode)
        else:
            prog = mode.reload(prog, cell, weights)
        out[seed] = mode.calibration_readings(cell, prog, pool, weights, seed)
        del weights, pool
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def calibrate(cell, seeds, control_seeds, device):
    mode = harness.mode_of(cell)
    few = seeds[:control_seeds]
    variants = {"sound": seeds, "control": few}
    variants.update({f: few for f in mode.FAULTS if f != "unchanged"})
    readings = {v: program_readings(cell, v, s, device) for v, s in variants.items()}
    rows = []
    for seed in seeds:
        weights, pool = harness.inputs_of(cell, seed, device)
        ref = mode.reference(cell, weights, pool, seed, device)
        for variant, by_seed in readings.items():
            if seed not in by_seed:
                continue
            values, _ = mode.compare(cell, by_seed.pop(seed), ref)
            row = {"workload": cell.name, "seed": seed, "variant": variant, **values}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del weights, pool, ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = calibrate(harness.load_cell(args.workload), args.seeds, args.control_seeds, "cuda")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
