#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs one CUDA card).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1; no result line is printed):

1. print the card's name and power limit; build every CUDA kernel of the
   port from the sources in this checkout (one nvcc per source, in parallel)
   and count the tensor-core instructions (HMMA) in each library's SASS;
2. hold each kernel (corr1d, corr2d) against its plain PyTorch version on
   the card at the main path's shape in fp32 and bf16 and at edge shapes
   (TF32 off), and time both at the main shape;
3. hold the eval forward on the card against the same model with the same
   weights on the CPU at 1x64x128 in fp32: the flagship (1dcorr), sdnet, and
   the flagship with 2dcorr;
4. serve the flagship: ``get_network`` + ``make_forward_fn`` (bf16 policy) at
   full width and depth (sdnet_mini_ext, densenet121, 1dcorr, 512x960,
   batches of 16 stereo pairs, random weights from a seed), check the
   outputs and the on-device metrics, and check that corr1d was launched
   once per batch and corr2d never;
5. serve sdnet the same way (densenet121, the 17x17 correlation), and check
   that corr2d was launched once per batch and corr1d never.

The third-to-last line of stdout is a JSON object with one record per
kernel, the second-to-last the card's name and power limit, and the last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve sdnet

only serves one net (phase 4 or 5, with 10 batches) and prints its time:
copied into the root of another checkout, it times that checkout's code the
same way, so two commits can be compared in turns in one call.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

PORT = "pmt_learning_for_semantic_segmentation_and_disparity_torch"
TPU_CORR = "pmt_learning_for_semantic_segmentation_and_disparity_tpu/ops/correlation.py"
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# dense peak operations per second by input type (H100 SXM data sheet):
# bf16 on the tensor cores, fp32 outside them
H100_PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH, H, W = 16, 512, 960          # the serving shape of the JAX package's bench
CORR_SHAPE = (BATCH, H // 8, W // 8, 352)  # a_py2 / b_py2 at 512x960
SMALL = (1, 64, 128, 3)
# net served -> (batches, each kernel's launches per batch): each path's own
# kernel once per batch, the other never
SERVE = {"sdnet_mini_ext": (4, {"corr1d": 1, "corr2d": 0}),
         "sdnet": (3, {"corr2d": 1, "corr1d": 0})}
SERVE_BATCHES = 10  # batches --serve serves, the first a warm-up

# kernel -> (wrapper in ops/correlation.py, the TPU kernel it replaces, edge
# shapes with their dtypes, and an element offset of both inputs' storage
# where it is not 0); its patch is ops/correlation.py's KERNEL_PATCH. fp32
# runs corr_tile.cuh's row tile, bf16 corr_band.cuh's tensor-core band tile
# (64-column tiles, 64-channel boxes of 16-channel mma steps; corr2d two rows
# a block).
KERNELS = {
    "corr1d": ("correlation1d_cuda", f"{TPU_CORR}:159", [
        ((1, 3, 9, 20), torch.float32),      # W < 17, B = 1
        ((2, 5, 70, 37), torch.bfloat16),    # W not a multiple of the 64-column tile,
        ((2, 5, 70, 37), torch.float32),     # C not a multiple of the 32-channel chunk
        ((1, 4, 130, 352), torch.float32),   # three tiles, the last of 2 columns
        ((1, 2, 16, 8), torch.bfloat16),     # C below one chunk
        ((1, 3, 16, 64), torch.bfloat16),    # W = 16, 17, 64, 65, 120 against the
        ((1, 3, 17, 64), torch.bfloat16),    # 64-column tile and its halo
        ((1, 3, 64, 64), torch.bfloat16),
        ((1, 3, 65, 64), torch.bfloat16),
        ((1, 3, 120, 64), torch.bfloat16),
        ((2, 3, 40, 16), torch.bfloat16),    # C = one mma step
        ((2, 3, 40, 24), torch.bfloat16),    # C = a step and a half
        ((1, 3, 70, 360), torch.bfloat16),   # C = 360: a last box of 40 channels
        ((2, 3, 70, 352), torch.bfloat16, 2),  # misaligned inputs: element staging
    ]),
    "corr2d": ("correlation2d_cuda", f"{TPU_CORR}:221", [
        ((1, 5, 9, 20), torch.float32),      # H, W < 17, B = 1 (vector loads)
        ((1, 5, 9, 20), torch.bfloat16),     # the same, scalar loads (20 % 8 != 0)
        ((2, 1, 70, 37), torch.float32),     # H = 1, W not a multiple of the tile,
        ((2, 1, 70, 37), torch.bfloat16),    # C not a multiple of the chunk
        ((2, 5, 70, 37), torch.bfloat16),
        ((1, 20, 130, 352), torch.float32),  # three tiles, rows in and out of reach
        ((1, 3, 16, 8), torch.bfloat16),     # C below one chunk
        ((1, 5, 16, 64), torch.bfloat16),    # W = 16, 17, 64, 65, 120 against the
        ((1, 5, 17, 64), torch.bfloat16),    # 64-column tile and its halo
        ((1, 5, 64, 64), torch.bfloat16),
        ((1, 5, 65, 64), torch.bfloat16),
        ((1, 5, 120, 64), torch.bfloat16),
        ((1, 17, 40, 32), torch.bfloat16),   # H = 17, 18 against the pair of rows
        ((1, 18, 40, 32), torch.bfloat16),   # a block owns and the 17 shifts
        ((2, 6, 40, 16), torch.bfloat16),    # C = one mma step
        ((2, 6, 40, 24), torch.bfloat16),    # C = a step and a half
        ((1, 20, 70, 360), torch.bfloat16),  # C = 360: a last box of 40 channels
        ((1, 6, 40, 1000), torch.bfloat16),  # f1 too large to stay resident
        ((1, 18, 70, 352), torch.bfloat16, 2),  # misaligned inputs: element staging
    ]),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def correlation_module():
    # by path: the package ``ops`` re-exports the function ``correlation``
    # over its module's name
    return importlib.import_module(f"{PORT}.ops.correlation")


def wrapper(name: str):
    return getattr(correlation_module(), KERNELS[name][0])


def phase_build():
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()), flush=True)
    # tensor-core instructions in each library's machine code: the bf16 band
    # tile's mma.sync compiles to HMMA
    cuobjdump = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    hmma = {}
    for name, path in paths.items():
        sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        hmma[name] = sum("HMMA" in line or "HGMMA" in line for line in sass.splitlines())
        print(f"[sass] {name}: {hmma[name]} HMMA/HGMMA instructions ({path.name})", flush=True)
        check(hmma[name] > 0, f"{name}: no tensor-core instruction in {path.name}")
    return hmma


def inputs(shape, dtype, g, offset: int = 0):
    """A contiguous random tensor whose storage starts ``offset`` elements
    into its allocation (offset 2 of a bf16 tensor: 4 bytes off 16-byte
    alignment)."""
    n = torch.Size(shape).numel()
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


def phase_kernel(name: str, sass_hmma: dict):
    """One kernel against correlation_plain; returns its JSON record
    (without the main path's launch count)."""
    correlation = correlation_module()
    correlation_plain = correlation.correlation_plain
    _, replaces, edges = KERNELS[name]
    patch = correlation.KERNEL_PATCH[name]
    fn = wrapper(name)
    arg = patch[1] if name == "corr1d" else patch
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16)] + edges
    # fp32: summation order only; bf16: the output's bf16 rounding (the plain
    # version also rounds each product to bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    record = {}
    for shape, dtype, *offset in cases:
        f1, f2 = (inputs(shape, dtype, g, *offset) for _ in range(2))
        out = fn(f1, f2, arg)
        torch.cuda.synchronize()
        ref = correlation_plain(f1, f2, patch)
        check(out.shape == ref.shape and out.dtype == dtype, f"{name} {shape} shape/dtype")
        err = (out.float() - ref.float()).abs().max().item()
        bound = tol[dtype] * ref.float().abs().max().item()
        where = f" at element offset {offset[0]}" if offset else ""
        print(f"[{name}] {tuple(shape)} {str(dtype)[6:]}{where}: max|d| = {err:.6g} "
              f"(tolerance {bound:.6g} = {tol[dtype]:g} * max|ref|)", flush=True)
        check(err <= bound, f"{name} {shape} {dtype}{where}: max|d| {err} > {bound}")
        if shape != CORR_SHAPE:
            continue
        ms = cuda_time_ms(lambda: fn(f1, f2, arg), iters=50)
        plain_ms = cuda_time_ms(lambda: correlation_plain(f1, f2, patch), iters=3, warmup=1)
        nbytes = (f1.numel() + f2.numel() + out.numel()) * f1.element_size()
        ops = 2 * out.numel() * shape[-1]
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_PEAK_OPS[dtype] * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"[{name}] {tuple(shape)} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
              f"{bound_ms / ms:.1%} of the bound", flush=True)
        if dtype == torch.bfloat16:  # the serving path's dtype
            record = {"name": name, "route": "cuda", "source": f"{PORT}/csrc/{name}.cu",
                      "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": None, "share_of_bound": bound_ms / ms,
                      "sass_hmma": sass_hmma[name]}
        del out, ref
    return record


def config(net: str, corr_type: str = "1dcorr", bf16: bool = False):
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import PMTConfig

    cfg = PMTConfig()
    cfg.model.net = net
    cfg.model.corr_type = corr_type
    cfg.parallel.bf16 = bf16
    return cfg


def phase_small_forward(net: str, corr_type: str):
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models

    cfg = config(net, corr_type)
    g = torch.Generator().manual_seed(1)
    left, right = torch.randn(SMALL, generator=g), torch.randn(SMALL, generator=g)
    with torch.inference_mode():
        ref = models.get_network(cfg, device="cpu", seed=0)(left, right)
        got = models.get_network(cfg, device="cuda", seed=0)(left.cuda(), right.cuda())
    for k in ("seg1", "seg2", "disp1", "disp2"):
        err = (got[k].cpu() - ref[k]).abs().max().item()
        bound = 1e-3 * ref[k].abs().max().item()
        print(f"[forward {net} {corr_type} 1x64x128 fp32] {k}: card vs CPU max|d| = {err:.6g} "
              f"(tolerance {bound:.6g} = 1e-3 * max|ref|)", flush=True)
        check(err <= bound, f"small forward {net} {corr_type} {k}: {err} > {bound}")


def phase_serve(net: str, n_batches: int, expect: dict):
    """Serve ``n_batches`` batches (the first a warm-up, not timed) and check
    each kernel's launches against ``expect`` (name -> launches per batch)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        compute_metrics,
        make_forward_fn,
    )

    cfg = config(net, bf16=True)
    model = models.get_network(cfg, seed=0)
    forward = make_forward_fn(cfg, model)
    g = torch.Generator(device="cuda").manual_seed(2)
    batches = []
    for _ in range(n_batches):
        labels = torch.randint(0, 2, (BATCH, H, W), device="cuda", generator=g)
        batches.append({
            "left": torch.randn((BATCH, H, W, 3), device="cuda", generator=g),
            "right": torch.randn((BATCH, H, W, 3), device="cuda", generator=g),
            "seg": torch.nn.functional.one_hot(labels, 3).float(),
            "disp": torch.rand((BATCH, H, W, 1), device="cuda", generator=g) * 0.9 + 0.1,
        })
    kernels = {name: wrapper(name) for name in expect}
    torch.cuda.synchronize()
    # no garbage and no cached blocks from an earlier phase: the objects the
    # kernel and small-forward phases leave would otherwise bring on a full
    # collection inside a timed batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    times = []
    with torch.inference_mode():
        for batch in batches:
            t0 = time.perf_counter()
            out = forward(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            for k, shape in (("seg1", 2), ("seg2", 2), ("disp1", 1), ("disp2", 1)):
                check(tuple(out[k].shape) == (BATCH, H, W, shape) and out[k].dtype == torch.float32,
                      f"serve {net}: {k} has shape {tuple(out[k].shape)} {out[k].dtype}")
                check(bool(torch.isfinite(out[k]).all()), f"serve {net}: {k} is not finite")
            metrics = compute_metrics(cfg, out, batch)
    launches = {name: k.launches for name, k in kernels.items()}
    for name, per_batch in expect.items():
        check(launches[name] == per_batch * n_batches,
              f"serve {net}: {name} launched {launches[name]} times in {n_batches} batches, "
              f"expected {per_batch} per batch")
    metrics = {k: v.tolist() for k, v in metrics.items()}
    check(metrics["conf1"] and sum(map(sum, metrics["conf1"])) == BATCH * H * W,
          f"serve {net}: confusion matrix does not count every pixel")
    check(all(torch.isfinite(torch.tensor(v)).all() for v in metrics.values()),
          f"serve {net}: a metric is not finite")
    timed = times[1:]
    ms = 1e3 * sum(timed) / len(timed)
    print(f"[serve {net}] metrics of the last batch: {json.dumps(metrics)}", flush=True)
    print(f"[serve {net}] densenet121 bf16, {BATCH} pairs of {H}x{W}: "
          f"{ms:.2f} ms/batch, {BATCH / ms * 1e3:.2f} pairs/s over {len(timed)} batches "
          f"(per batch: {', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first a warm-up); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", choices=sorted(SERVE), help="only serve this net and time it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.serve:
        try:
            phase_serve(args.serve, SERVE_BATCHES, SERVE[args.serve][1])
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        hmma = phase_build()
        records = {name: phase_kernel(name, hmma) for name in KERNELS}
        for net, corr_type in (("sdnet_mini_ext", "1dcorr"), ("sdnet", "2dcorr"),
                               ("sdnet_mini_ext", "2dcorr")):
            phase_small_forward(net, corr_type)
        for net, kernel in (("sdnet_mini_ext", "corr1d"), ("sdnet", "corr2d")):
            records[kernel]["launches"] = phase_serve(net, *SERVE[net])[kernel]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
