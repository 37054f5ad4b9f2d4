"""corr2d's bf16 backward, or its fp32 forward and backward, of two trees in
turns, on one CUDA card.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.turns_backward \
        --parent DIR [--fp32] [--rounds 1] [--out report.json]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Each turn is a process of its own that imports the
port's package from one tree, builds that tree's kernels there and times its
``correlation2d_backward_cuda`` -- the wrapper, as the train step calls it,
allocations and all -- in bf16 at the training shape per view
(8, 32, 64, C) for C = 352, 608 and 1024 and at the serving shape
(16, 64, 120, 352): each launch timed by its own pair of CUDA events behind
a ~0.2 ms spin of the card, with the L2 flushed before it (256 MB written)
and warm, 50 launches each, after a warm-up. The inputs come from one seed,
so both trees see the same tensors; each turn also holds its gradients
against ``correlation2d_vjp_plain`` (bf16 tolerance 1e-2 * max|ref|).

``--fp32`` times the fp32 path at the same shapes instead: the forward
wrapper ``correlation2d_cuda``, each launch timed alone, warm (it reads 65 to
488 MB, most of which the L2 cannot keep between launches), and the backward
as above, flushed and warm; each held against ``correlation_plain`` and
``correlation2d_vjp_plain`` at the fp32 tolerance 1e-4 * max|ref|.

Turns run parent, this tree, this tree, parent (``--rounds`` times). Prints
each turn's times, the card's name and power limit, and one JSON line
(written to ``--out`` too). Exits non-zero without a card or when a turn
fails.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((8, 32, 64, 352), (16, 64, 120, 352), (8, 32, 64, 608), (8, 32, 64, 1024))
FLUSH_BYTES = 256 * 2**20
PACKAGE = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
THIS_ROOT = Path(__file__).resolve().parents[2]


def event_times(fn, iters: int, flush):
    """(mean, median) ms of ``fn``, each launch timed by its own events
    behind a spin of the card; ``flush`` (a tensor) is zeroed before each."""
    import torch

    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(400_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return sum(times) / iters, times[iters // 2]


def share_of_tolerance(got, ref, tol: float) -> float:
    """max over the tensors of max|got - ref| / (tol * max|ref|)."""
    return max(((a.float() - b.float()).abs().max() / (tol * b.float().abs().max())).item()
               for a, b in zip(got, ref))


def time_tree(root: str, fp32: bool = False) -> dict:
    """One turn: the wrappers of the tree at ``root``, timed at SHAPES (bf16
    backward, or with ``fp32`` the fp32 forward and backward)."""
    import torch

    sys.path.insert(0, root)
    correlation = importlib.import_module(f"{PACKAGE}.ops.correlation")
    assert Path(correlation.__file__).resolve().is_relative_to(Path(root).resolve()), correlation.__file__
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    dtype, tol = (torch.float32, 1e-4) if fp32 else (torch.bfloat16, 1e-2)
    out = {}
    for shape in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        f1, f2 = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(2))
        grad = torch.randn(shape[:3] + (289,), device="cuda", generator=g).to(dtype)
        key = "x".join(map(str, shape))
        if fp32:
            share = share_of_tolerance([correlation.correlation2d_cuda(f1, f2, (17, 17))],
                                       [correlation.correlation_plain(f1, f2, (17, 17))], tol)
            if share > 1:
                raise SystemExit(f"{root} {shape} forward: max|d| is {share:.3g} of its tolerance")
            fwd = event_times(lambda: correlation.correlation2d_cuda(f1, f2, (17, 17)), 50, None)
            out[f"forward {key}"] = {"warm_mean": fwd[0], "warm_median": fwd[1],
                                     "err_share_of_tolerance": share}
        share = share_of_tolerance(correlation.correlation2d_backward_cuda(f1, f2, grad),
                                   correlation.correlation2d_vjp_plain(f1, f2, grad, (17, 17)), tol)
        if share > 1:
            raise SystemExit(f"{root} {shape}: max|d| is {share:.3g} of its tolerance")
        run = lambda: correlation.correlation2d_backward_cuda(f1, f2, grad)  # noqa: E731
        flushed = event_times(run, 50, flush)
        warm = event_times(run, 50, None)
        out[f"backward {key}" if fp32 else key] = {
            "flushed_mean": flushed[0], "flushed_median": flushed[1], "warm_mean": warm[0],
            "warm_median": warm[1], "err_share_of_tolerance": share}
        del f1, f2, grad
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of parent, this, this, parent")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--fp32", action="store_true",
                    help="time the fp32 forward and backward instead of the bf16 backward")
    ap.add_argument("--time", metavar="ROOT", help=argparse.SUPPRESS)  # one turn, in its own process
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("turns_backward: no CUDA device", file=sys.stderr)
        return 2
    if args.time:
        print(json.dumps(time_tree(args.time, args.fp32)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    trees = {"parent": str(Path(args.parent).resolve()), "this": str(THIS_ROOT)}
    turns = []
    for _ in range(args.rounds):
        for name in ("parent", "this", "this", "parent"):
            proc = subprocess.run([sys.executable, __file__, "--time", trees[name]]
                                  + ["--fp32"] * args.fp32, capture_output=True, text=True,
                                  timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            turns.append({"tree": name, "ms": times})
            for shape, t in times.items():
                flushed = (f"{t['flushed_mean']:.4f} ms flushed (median {t['flushed_median']:.4f}), "
                           if "flushed_mean" in t else "")
                print(f"[turns {name}] {shape} {'fp32' if args.fp32 else 'bf16'}: {flushed}"
                      f"{t['warm_mean']:.4f} ms warm (median {t['warm_median']:.4f}); max|d| "
                      f"{t['err_share_of_tolerance']:.3g} of the tolerance", flush=True)
    report = {"card": card, "dtype": "float32" if args.fp32 else "bfloat16", "trees": trees,
              "turns": turns}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
