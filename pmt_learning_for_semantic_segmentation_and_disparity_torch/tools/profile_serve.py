"""Where the serving forward's device time goes, on one CUDA card.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.profile_serve \
        [--net sdnet_mini_ext] [--out report.json]

Runs the eval forward of one net of the port (the flagship ``sdnet_mini_ext``
by default; ``get_network`` + ``make_forward_fn`` with the bf16 policy, random
weights from a seed) on 16 stereo pairs of 512x960, the serving shape of
``chip_smoke.py``, twice as a warm-up, then ``ITERS``
batches under ``torch.profiler``. Prints the device time of the kernels by
family and the heaviest kernels by name, the device busy share of the window
(kernel time over the host's wall time of the window), and, with ``--out``,
writes the same as JSON there. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..core import PMTConfig
from ..models import MODELS, get_network
from ..training import make_forward_fn

BATCH, H, W = 16, 512, 960
ITERS = 2

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("corr1d", ("corr1d",)),
    ("corr2d", ("corr2d",)),
    ("batch_norm", ("batch_norm", "bn_fw", "batchnorm")),
    ("concatenate", ("catarray",)),
    ("resize", ("upsample",)),
    ("pooling", ("pool",)),
    ("copy_cast", ("copy_kernel", "direct_copy")),
    ("convolution", ("conv", "xmma", "implicit", "gemm", "cutlass", "fprop", "nvjet", "cudnn")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="sdnet_mini_ext", choices=sorted(MODELS.keys()),
                    help="the net to serve (default: the flagship)")
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = PMTConfig()
    cfg.model.net = args.net
    cfg.parallel.bf16 = True
    forward = make_forward_fn(cfg, get_network(cfg, seed=0))
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"left": torch.randn((BATCH, H, W, 3), device="cuda", generator=g),
             "right": torch.randn((BATCH, H, W, 3), device="cuda", generator=g)}
    with torch.inference_mode():
        for _ in range(2):
            forward(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                forward(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the rows of the CPU-side operators repeat their kernels' time
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.key][0] += ev.self_device_time_total / 1e3
            by_name[ev.key][1] += ev.count
    kernel_ms = sum(ms for ms, _ in by_name.values())
    by_family = defaultdict(float)
    for name, (ms, _) in by_name.items():
        by_family[family(name)] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    report = {
        "card": card, "device": torch.cuda.get_device_name(0),
        "net": args.net,
        "shape": [BATCH, H, W], "dtype": "bf16", "iters": ITERS,
        "wall_ms_per_batch": wall_ms / ITERS,
        "kernel_ms_per_batch": kernel_ms / ITERS,
        "device_busy_share": kernel_ms / wall_ms if wall_ms > 0 else None,
        "by_family_ms_per_batch": {k: v / ITERS for k, v in
                                   sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:160], "ms_per_batch": ms / ITERS,
                         "calls_per_batch": c / ITERS} for n, (ms, c) in top],
    }
    print(f"[profile] {args.net} {BATCH}x{H}x{W} bf16: wall {report['wall_ms_per_batch']:.3f} ms/batch, "
          f"kernels {report['kernel_ms_per_batch']:.3f} ms/batch, "
          f"device busy {report['device_busy_share']}", flush=True)
    for fam, ms in report["by_family_ms_per_batch"].items():
        print(f"[profile] {fam:12s} {ms:10.3f} ms/batch", flush=True)
    for k in report["top_kernels"]:
        print(f"[profile] {k['ms_per_batch']:10.3f} ms {k['calls_per_batch']:7.1f}x  {k['name']}",
              flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    return 0 if kernel_ms > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
