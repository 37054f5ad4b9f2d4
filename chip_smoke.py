#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (needs one CUDA card).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1; no result line is printed):

1. print the card's name and power limit; build every CUDA kernel of the
   port from the sources in this checkout (one nvcc per source, in parallel)
   and read each library's SASS;
2. hold each kernel (corr1d, corr2d) against its plain PyTorch version on
   the card at the main path's shape in fp32 and bf16 and at edge shapes
   (TF32 off), time both at the main shape, and count the tensor-core
   instructions (HMMA) in the SASS of its bf16 function;
   hold each backward kernel against its plain VJP the same way
   (corr1d's against ``correlation1d_vjp_plain`` at ``BACKWARD_CASES``,
   corr2d's against ``correlation2d_vjp_plain`` at ``BACKWARD2_CASES``: the
   training shape per view, the serving shape and edge shapes of its
   transposed band), count HMMA in its own bf16 function, time it warm and
   with the L2 flushed before each launch, and hold the gradients that
   ``torch.autograd.grad`` takes through ``correlation`` (forward kernel,
   then backward kernel) at the training shape;
3. hold the eval forward on the card against the same model with the same
   weights on the CPU at 1x64x128 in fp32: the flagship (1dcorr), sdnet, and
   the flagship with 2dcorr; and one fp32 train step of the flagship and one
   of sdnet (the bench loss stack, Adam) from the same weights and batch: in
   train mode, the loss and every updated BatchNorm running statistic within
   1e-3 * max|ref| (the flagship's gradients also within twice the devices'
   own fp32 noise); with ``freeze_bn`` (BatchNorm on its running statistics)
   on images scaled by 1e-2 and cuDNN off, the loss and every gradient
   tensor within 1e-3 * max|ref|; with cuDNN on (TF32 off), under each of
   ``CUDNN_SETTINGS``, the tensor farthest from the CPU's and the image
   convolutions' weights are printed, not held, each with its distance from
   a float64 weight gradient of the same inputs and the card's kernels;
4. serve the flagship: ``get_network`` + ``make_forward_fn`` (bf16 policy) at
   full width and depth (sdnet_mini_ext, densenet121, 1dcorr, 512x960,
   batches of 16 stereo pairs, random weights from a seed), check the
   outputs and the on-device metrics, and check that corr1d was launched
   once per batch and corr2d never;
5. serve sdnet the same way (densenet121, the 17x17 correlation), and check
   that corr2d was launched once per batch and corr1d never;
6. train the flagship: ``get_network`` + ``TrainState.create`` +
   ``make_train_step`` (bf16 policy, CE + Lovász + MultiTversky + OHEM, Adam)
   on batches of 8 stereo pairs of 256x512, 2 warm-up and 8 timed steps:
   finite losses, corr1d's forward and backward kernels once per step each,
   corr2d's never; ms/step, pairs/s and peak memory;
7. train sdnet the same way: corr2d's forward and backward kernels once per
   step each, corr1d's never.

The third-to-last line of stdout is a JSON object with one record per
kernel, the second-to-last the card's name and power limit, and the last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --serve sdnet

only serves one net (phase 4 or 5, with 10 batches) and prints its time,
and ``python3 chip_smoke.py --train [sdnet]`` only trains (phase 6, or 7
with ``sdnet``, 2 warm-up and 10 timed steps): copied into the root of
another checkout, it times that checkout's code the same way, so two commits
can be compared in turns in one call; ``python3 chip_smoke.py --backward
[corr2d]`` does the same for a backward kernel (corr1d's by default: its
four timed cases of phase 2, without the HMMA count).
``python3 chip_smoke.py --kernels`` runs phases 1 and 2 only and prints the
kernels' record but no result line.
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
# training: the JAX package's bench (bench.py:192-198)
TRAIN_BATCH, TRAIN_H, TRAIN_W = 8, 256, 512
TRAIN_LOSSES = ("cross_entropy", "lovasz_loss", "tversky_loss", "ohm_loss")
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_H // 8, TRAIN_W // 8, 352)  # a_py2 of one view
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# corr1d's backward against correlation1d_vjp_plain: the training shape per
# view (main path) and the serving shape in both dtypes, then edge shapes of
# the bf16 transposed band (64-column tiles with an 8-column halo, 64-channel
# boxes) and of the fp32 tile (64 columns x 64 channels, 4 channels a
# thread), with an element offset of the inputs' storage where one is given
BACKWARD_CASES = [
    (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
    (CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16),
    ((1, 3, 63, 64), torch.bfloat16),       # W against the 64-column tile and its halo:
    ((1, 3, 64, 64), torch.bfloat16),       # one tile short, one tile, one column over,
    ((1, 3, 65, 64), torch.bfloat16),       # the serving width, two whole tiles
    ((2, 3, 120, 64), torch.bfloat16),
    ((1, 3, 128, 64), torch.bfloat16),
    ((2, 3, 16, 64), torch.bfloat16),       # W < 17: the halo is wider than the map
    ((1, 2, 9, 20), torch.bfloat16),        # W < 17 and C % 8 != 0: element staging
    ((2, 3, 40, 24), torch.bfloat16),       # C < 64: one box, clipped by the copy engine
    ((1, 3, 70, 352), torch.bfloat16),      # C = 352: a last box of 32 channels
    ((1, 3, 70, 360), torch.bfloat16),      # C = 360: a last box of 40 channels
    ((2, 3, 33, 37), torch.bfloat16),       # C % 8 != 0: element staging and stores
    ((2, 3, 70, 352), torch.bfloat16, 1),   # inputs off 16-byte alignment: element
    ((2, 3, 70, 352), torch.bfloat16, 2),   # staging and stores
    ((1, 2, 9, 20), torch.float32),         # fp32: W < 17, C % 4 == 0 (float4 staging)
    ((2, 3, 17, 64), torch.float32),        # W = 17
    ((1, 3, 65, 64), torch.float32),        # one column past the 64-column tile
    ((1, 3, 130, 360), torch.float32),      # three tiles, a 40-channel tail
    ((2, 3, 33, 37), torch.float32),        # C % 4 != 0: element staging and stores
    ((2, 3, 65, 36), torch.float32, 1),     # inputs off 16-byte alignment
    ((2, 3, 33, 37), torch.float32, 1),
]
# corr2d's backward against correlation2d_vjp_plain: the training and
# serving shapes in both dtypes, then edge shapes: H and W against the 8-row
# and 8-column reach of the patch and the 64-column tile (1, 7, 16, 17, 18,
# 65), C against the 64-channel box (16, 24, 352, 360), element staging (C %
# 8 != 0 in bf16, C % 4 != 0 in fp32) and element offsets of the storage
BACKWARD2_CASES = [
    (TRAIN_SHAPE, torch.float32), (TRAIN_SHAPE, torch.bfloat16),
    (CORR_SHAPE, torch.float32), (CORR_SHAPE, torch.bfloat16),
    ((1, 1, 65, 64), torch.bfloat16),       # H = 1: one row offset
    ((1, 65, 1, 64), torch.bfloat16),       # W = 1
    ((2, 7, 7, 24), torch.bfloat16),        # H, W below the patch's reach; C < 64
    ((1, 16, 17, 16), torch.bfloat16),      # C = one mma step
    ((1, 17, 16, 64), torch.bfloat16),
    ((1, 18, 18, 360), torch.bfloat16),     # C = 360: a last box of 40 channels
    ((1, 18, 65, 352), torch.bfloat16),     # a tile and one column; a 32-channel box
    ((2, 9, 20, 37), torch.bfloat16),       # C % 8 != 0: element staging and stores
    ((1, 18, 70, 352), torch.bfloat16, 2),  # inputs off 16-byte alignment
    ((1, 1, 7, 24), torch.float32),         # fp32: H = 1, W < 8
    ((1, 7, 1, 16), torch.float32),         # W = 1
    ((2, 17, 18, 64), torch.float32),
    ((1, 18, 65, 360), torch.float32),      # one column past the tile, a 40-channel tail
    ((2, 9, 20, 37), torch.float32),        # C % 4 != 0: element staging and stores
    ((1, 16, 70, 36), torch.float32, 1),    # inputs off 16-byte alignment
    ((1, 16, 17, 352), torch.float32, 2),
]
# backward kernel -> (wrapper, plain VJP, cases, the TPU code it replaces,
# the name of its bf16 function)
BACKWARDS = {
    "corr1d": ("correlation1d_backward_cuda", "correlation1d_vjp_plain", BACKWARD_CASES,
               f"{TPU_CORR}:320", "corr1d_bwd_band_kernel"),
    "corr2d": ("correlation2d_backward_cuda", "correlation2d_vjp_plain", BACKWARD2_CASES,
               f"{TPU_CORR}:368", "corr2d_bwd_band_kernel"),
}
# net trained -> each kernel's launches per step: its path's forward and
# backward kernels once each, the other correlation's never
TRAIN = {"sdnet_mini_ext": {"corr1d": 1, "corr1d_backward": 1, "corr2d": 0, "corr2d_backward": 0},
         "sdnet": {"corr2d": 1, "corr2d_backward": 1, "corr1d": 0, "corr1d_backward": 0}}
# the cuDNN settings phase 3 reads (prints) on the freeze_bn step, TF32 off
CUDNN_SETTINGS = {"default": {}, "deterministic": {"deterministic": True},
                  "benchmark": {"benchmark": True}}
# bytes written between two launches to flush the card's 50 MB L2 (the
# "cold" backward times)
FLUSH_BYTES = 256 * 2**20

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
    """Build every kernel library; returns {library: its SASS}."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.ops import _kernels

    t0 = time.perf_counter()
    paths = _kernels.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()), flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    return {name: subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                                 check=True, timeout=120).stdout
            for name, path in paths.items()}


def hmma_count(sass: dict, library: str, function: str) -> int:
    """Tensor-core instructions (HMMA/HGMMA) in the machine code of the
    library's functions whose (mangled) name holds ``function``; fails if
    there are none. The bf16 band tiles' mma.sync compiles to HMMA."""
    counts, current = {}, None
    for line in sass[library].splitlines():
        if line.strip().startswith("Function :"):
            current = line.split(":", 1)[1].strip()
            if function in current:
                counts[current] = 0
        elif current in counts and ("HMMA" in line or "HGMMA" in line):
            counts[current] += 1
    total = sum(counts.values())
    print(f"[sass] {library} {function}: {total} HMMA/HGMMA instructions in "
          f"{len(counts)} function(s) ({', '.join(f'{v}' for v in counts.values())})", flush=True)
    check(all(counts.values()) and counts,
          f"{library}: no tensor-core instruction in a function named *{function}*")
    return total


def inputs(shape, dtype, g, offset: int = 0):
    """A contiguous random tensor whose storage starts ``offset`` elements
    into its allocation (offset 2 of a bf16 tensor: 4 bytes off 16-byte
    alignment)."""
    n = torch.Size(shape).numel()
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


def phase_kernel(name: str, sass: dict):
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
                      "sass_hmma": hmma_count(sass, name, f"{name}_band_kernel")}
        del out, ref
    return record


def event_time_ms(fn, iters: int, flush: bool, warmup: int = 3):
    """(mean, median) ms of ``fn``, each launch timed by its own pair of
    events behind a ~0.2 ms spin of the card, so that the launch waits on the
    card and not on the host's call; with ``flush``, the L2 is flushed
    before each launch (FLUSH_BYTES written)."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if flush else None
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if flush:
            buf.zero_()
        torch.cuda._sleep(400_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return sum(times) / iters, times[iters // 2]


def phase_backward(name: str, sass, cases=None, autograd: bool = True):
    """The backward kernel of ``name`` (corr1d, corr2d) against its plain VJP
    at ``cases`` (its ``BACKWARDS`` cases by default); returns its JSON record
    (without the main path's launch count): the bf16 function's HMMA count
    (``sass`` None: not counted), and its times at the training shape per
    view in bf16 with the L2 flushed before each launch (``ms``, the time
    compared with the byte bound), warm (``ms_warm``, each launch timed by its
    own events) and back to back (``ms_back_to_back``, which at this shape
    measures the wrapper's host time)."""
    correlation = correlation_module()
    wrapper_name, plain_name, default_cases, replaces, band_fn = BACKWARDS[name]
    kernel = getattr(correlation, wrapper_name)
    patch = correlation.KERNEL_PATCH[name]
    arg = patch[1] if name == "corr1d" else patch

    def plain(f1, f2, grad):
        return getattr(correlation, plain_name)(f1, f2, grad, arg)

    hmma = hmma_count(sass, name, band_fn) if sass else None
    g = torch.Generator(device="cuda").manual_seed(3)
    # fp32: summation order only; bf16: the outputs' bf16 rounding (the plain
    # version also rounds each product to bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

    def hold(got, ref, what: str, shape, dtype):
        errs = []
        for k, a, b in (("df1", got[0], ref[0]), ("df2", got[1], ref[1])):
            check(a.shape == b.shape == shape and a.dtype == dtype, f"{what} {k} shape/dtype")
            err = (a.float() - b.float()).abs().max().item()
            bound = tol[dtype] * b.float().abs().max().item()
            print(f"{what} {k}: max|d| = {err:.6g} (tolerance {bound:.6g} = {tol[dtype]:g} * max|ref|)",
                  flush=True)
            check(err <= bound, f"{what} {k}: max|d| {err} > {bound}")
            errs.append(err)
        return errs

    record = {}
    for shape, dtype, *offset in default_cases if cases is None else cases:
        f1, f2 = (inputs(shape, dtype, g, *offset) for _ in range(2))
        grad = inputs(tuple(shape[:3]) + (patch[0] * patch[1],), dtype, g, *offset)
        got = kernel(f1, f2, grad)
        torch.cuda.synchronize()
        where = f" at element offset {offset[0]}" if offset else ""
        errs = hold(got, plain(f1, f2, grad), f"[{name} backward] {tuple(shape)} {str(dtype)[6:]}{where}",
                    f1.shape, dtype)
        if offset or shape not in (TRAIN_SHAPE, CORR_SHAPE):
            continue
        # back to back (as the forward kernels are timed): the card's time
        # per launch, or the wrapper's host time where that is longer
        b2b_ms = cuda_time_ms(lambda: kernel(f1, f2, grad), iters=50)
        t0 = time.perf_counter()
        for _ in range(50):
            kernel(f1, f2, grad)
        host_ms = 1e3 * (time.perf_counter() - t0) / 50
        torch.cuda.synchronize()
        warm_ms, warm_median = event_time_ms(lambda: kernel(f1, f2, grad), 50, flush=False)
        ms, median_ms = event_time_ms(lambda: kernel(f1, f2, grad), 50, flush=True)
        plain_ms = cuda_time_ms(lambda: plain(f1, f2, grad), iters=3, warmup=1)
        # read f1, f2 and g once, write df1 and df2 once; the useful products
        # at the dtype's peak
        nbytes = (4 * f1.numel() + grad.numel()) * f1.element_size()
        ops = 2 * 2 * grad.numel() * shape[-1]
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_PEAK_OPS[dtype] * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"[{name} backward] {tuple(shape)} {str(dtype)[6:]}: kernel {ms:.4f} ms with the L2 "
              f"flushed (median {median_ms:.4f}), {warm_ms:.4f} ms warm (median {warm_median:.4f}), "
              f"{b2b_ms:.4f} ms a launch back to back (host {host_ms:.4f} ms a call), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP, by {'bytes' if t_bytes >= t_ops else 'operations'}), "
              f"{bound_ms / ms:.1%} of the bound flushed, {bound_ms / warm_ms:.1%} warm", flush=True)
        if shape == TRAIN_SHAPE and dtype == torch.bfloat16:  # the training path's
            record = {"name": f"{name}_backward", "route": "cuda",
                      "source": f"{PORT}/csrc/{name}.cu",
                      "replaces": replaces, "max_abs_err": max(errs), "ms": ms,
                      "ms_warm": warm_ms, "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": None, "share_of_bound": bound_ms / ms, "sass_hmma": hmma}
        del got
    # the autograd wiring the train step runs: the gradients of the
    # dispatcher the models call (the forward kernel, then the backward
    # kernel from the autograd Function's backward) against the plain VJP;
    # corr2d as the nets call it, normalized by C outside the kernels
    normalize = name == "corr2d"
    for dtype in (torch.float32, torch.bfloat16) if autograd else ():
        f1, f2 = (inputs(TRAIN_SHAPE, dtype, g).requires_grad_() for _ in range(2))
        grad = inputs(TRAIN_SHAPE[:3] + (patch[0] * patch[1],), dtype, g)
        before = kernel.launches
        got = torch.autograd.grad(correlation.correlation(f1, f2, patch, normalize=normalize),
                                  (f1, f2), grad)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"autograd through correlation: {name}'s backward "
              f"kernel was launched {kernel.launches - before} times, expected once")
        scaled = grad / TRAIN_SHAPE[-1] if normalize else grad
        hold(got, plain(f1.detach(), f2.detach(), scaled),
             f"[{name} autograd{' normalized' if normalize else ''}] {TRAIN_SHAPE} {str(dtype)[6:]}",
             f1.shape, dtype)
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


def train_batch(shape, g, device):
    """A random batch (images, one-hot roses labels, disparity) of ``shape``
    (B, H, W) from the generator ``g``."""
    labels = torch.randint(0, 2, shape, device=device, generator=g)
    return {"left": torch.randn(shape + (3,), device=device, generator=g),
            "right": torch.randn(shape + (3,), device=device, generator=g),
            "seg": torch.nn.functional.one_hot(labels, 2).float(),
            "disp": torch.rand(shape + (1,), device=device, generator=g)}


def train_setup(net: str, device: str, bf16: bool, freeze_bn: bool = False):
    """The net, its Adam train state and its train step on ``device`` (the
    same weights from seed 0 on every device)."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import (
        TrainState,
        build_optimizer,
        make_train_step,
    )

    cfg = config(net, bf16=bf16)
    cfg.loss.losses = TRAIN_LOSSES
    cfg.optim.freeze_bn = freeze_bn
    model = models.get_network(cfg, device=device, seed=0)
    state = TrainState.create(model, build_optimizer(cfg.optim, cfg.model.net, len(TRAIN_LOSSES)))
    return model, state, make_train_step(cfg, model, device=device)


def rel_l2(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over all tensors of two {name: tensor} dicts."""
    num = sum(float(((got[n].double() - r.double()) ** 2).sum()) for n, r in ref.items())
    return (num / sum(float((r.double() ** 2).sum()) for r in ref.values())) ** 0.5


def grads_at_perturbed_weights(device: str, batch: dict) -> dict:
    """The flagship's fp32 train-mode gradient on ``device`` at the seed-0
    weights perturbed by a relative 1e-7 (the same perturbation on every
    device): how far fp32 rounding alone moves the gradient."""
    from pmt_learning_for_semantic_segmentation_and_disparity_torch import models
    from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import make_loss_fn

    cfg = config("sdnet_mini_ext")
    cfg.loss.losses = TRAIN_LOSSES
    model = models.get_network(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    loss, _ = make_loss_fn(cfg, model, device=device)(batch, True)
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def small_step(net: str, device: str, batch: dict, freeze_bn: bool = False, convs: dict = None):
    """One fp32 train step of ``net`` on ``device`` from the seed-0 weights:
    the loss, {name: gradient} and {name: BatchNorm running statistic}, on
    the CPU. ``convs``, a dict, receives {conv name: [(input, output
    gradient) of each call]} of every plain convolution."""
    model, state, step = train_setup(net, device, bf16=False, freeze_bn=freeze_bn)
    hooks = []
    if convs is not None:
        def record(name):
            def hook(module, args, out):
                x = args[0].detach()
                out.register_hook(lambda gy: convs.setdefault(name, []).append((x, gy.detach())))
            return hook

        hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
                 if type(m) is torch.nn.Conv2d]
    _, metrics = step(state, batch)
    for h in hooks:
        h.remove()
    if convs is not None:
        convs["_model"] = model
    return (metrics["loss"].item(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))})


def hold_loss(tag: str, loss: float, ref: float) -> None:
    err = abs(loss - ref)
    print(f"{tag} loss card {loss:.8g} CPU {ref:.8g}: |d| = {err:.6g} "
          f"(tolerance {1e-3 * abs(ref):.6g} = 1e-3 * |ref|)", flush=True)
    check(err <= 1e-3 * abs(ref), f"{tag}: loss {loss} against {ref}")


def worst_tensor(got: dict, ref: dict):
    """(max|d| / max|ref|, name) of the tensor of ``got`` farthest from
    ``ref``'s, relative to its own largest reference value."""
    return max(((got[n] - r).abs().max().item() / (r.abs().max().item() or float("inf")), n)
               for n, r in ref.items())


def hold_tensors(tag: str, what: str, got: dict, ref: dict) -> None:
    """Every tensor of ``got`` within 1e-3 * max|ref| of ``ref``'s."""
    check(set(got) == set(ref), f"{tag}: {what} of other names")
    for n, r in ref.items():
        err, bound = (got[n] - r).abs().max().item(), 1e-3 * r.abs().max().item()
        check(err <= bound, f"{tag}: {what} {n}: max|d| {err} > {bound}")
    rel, name = worst_tensor(got, ref)
    print(f"{tag} every {what} tensor ({len(ref)}) within 1e-3 * max|ref| of the CPU's; the "
          f"closest to its bound: {name} at {rel / 1e-3:.3g} of it", flush=True)


def wgrad_probe(conv: torch.nn.Conv2d, calls: list):
    """The weight gradient of ``conv`` from its recorded (input, output
    gradient) calls, recomputed on the card under the current cuDNN flags:
    (the names of the card's kernels, max|d| / max|ref| against the same
    sum in float64 on the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wgrad(x, gy):
        return torch.nn.grad.conv2d_weight(x, conv.weight.shape, gy, conv.stride, conv.padding,
                                           conv.dilation, conv.groups)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dw = sum(wgrad(x, gy) for x, gy in calls)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("void at::native")})  # cuDNN's, not the sums
    ref = sum(wgrad(x.cpu().double(), gy.cpu().double()) for x, gy in calls)
    return names, ((dw.cpu().double() - ref).abs().max() / ref.abs().max()).item()


def phase_small_train(net: str):
    """One fp32 train step of ``net`` on the card against the CPU from the
    same weights and batch (TF32 off).

    In train mode: the loss and every updated BatchNorm running statistic
    within 1e-3 * max|ref|, and for the flagship the gradients within twice
    the two devices' own fp32 noise. Train-mode BatchNorm makes the
    flagship's fp32 gradient ill-conditioned: a 1e-7 relative change of the
    weights moves it by percents, so no per-tensor bound of 1e-3 can hold
    there.

    With ``freeze_bn`` (BatchNorm on its running statistics, its gradients
    zeroed) the gradient is well-conditioned once no softmax or attention
    gate saturates, so the images are scaled by 1e-2 (at random init and
    scale 1 the eval-mode outputs reach ~1e4, and a saturated gate's
    gradient is rounding noise): the loss and every gradient tensor within
    1e-3 * max|ref|, with cuDNN off. With cuDNN on the check cannot hold for
    the flagship: the first convolution's weight gradient, a sum over every
    pixel that mostly cancels, reads 1.33e-3 * max|ref| under every one of
    ``CUDNN_SETTINGS``, though cuDNN's weight gradient from the same inputs
    agrees with float64 to ~1e-6 (PERF.md §7). So each setting is read and
    printed: the gradient tensor farthest from the CPU's and the image
    convolutions' weights, each with the kernels of its weight gradient on
    the card and its distance from a float64 sum of the same inputs. The
    float64 CPU tests hold the train-mode gradients against the JAX package
    per tensor."""
    tag = f"[train {net} 1x64x128 fp32]"
    batch = train_batch(SMALL[:3], torch.Generator().manual_seed(4), "cpu")
    (ref_loss, ref_grads, ref_stats), (loss, grads, stats) = (
        small_step(net, d, batch) for d in ("cpu", "cuda"))
    hold_loss(tag, loss, ref_loss)
    hold_tensors(tag, "BN running statistic", stats, ref_stats)
    if net == "sdnet_mini_ext":
        noise = {}
        for device in ("cpu", "cuda"):
            noisy = grads_at_perturbed_weights(device, batch)
            noise[device] = rel_l2({n: noisy[n] for n in ref_grads if n in noisy},
                                   {n: ref_grads[n] for n in ref_grads if n in noisy})
        diff = rel_l2(grads, ref_grads)
        print(f"{tag} gradients card vs CPU: ||d|| / ||ref|| = {diff:.4g} over {len(ref_grads)} "
              f"tensors; fp32 noise (1e-7 weight perturbation): CPU {noise['cpu']:.4g}, card "
              f"{noise['cuda']:.4g}; tolerance {2 * sum(noise.values()):.4g} = 2 * (CPU + card noise)",
              flush=True)
        check(diff <= 2 * sum(noise.values()),
              f"small train step: gradients off the CPU's by {diff}, noise {noise}")

    tag = f"[train {net} 1x64x128 fp32 freeze_bn, images x 1e-2]"
    small = dict(batch, left=batch["left"] * 1e-2, right=batch["right"] * 1e-2)
    ref_loss, ref_grads, _ = small_step(net, "cpu", small, freeze_bn=True)
    for setting, flags in CUDNN_SETTINGS.items():
        convs = {}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False, **flags):
            grads = small_step(net, "cuda", small, freeze_bn=True, convs=convs)[1]
            # the tensor farthest from the CPU's, and the image convolutions'
            # weights (the first layer's gradient sums over every pixel)
            rel, worst = worst_tensor(grads, ref_grads)
            names = [worst] + sorted(n for n in ref_grads if n.startswith("conv2d_ba") and n != worst)
            for name in names:
                module = name.rsplit(".", 1)[0]
                probe = (wgrad_probe(convs["_model"].get_submodule(module), convs[module])
                         if module in convs and name.endswith(".weight") else None)
                rel = worst_tensor({name: grads[name]}, {name: ref_grads[name]})[0]
                print(f"{tag} cuDNN {setting}: {name}{' (the farthest)' if name == worst else ''} "
                      f"at max|d| = {rel:.3g} * max|ref| from the CPU's" + (
                          f"; its weight gradient alone on the card from the same inputs against "
                          f"float64: {probe[1]:.3g} * max|ref|, kernels {probe[0]}" if probe else ""),
                      flush=True)
    with torch.backends.cudnn.flags(enabled=False):
        loss, grads, _ = small_step(net, "cuda", small, freeze_bn=True)
    tag += " cuDNN off"
    hold_loss(tag, loss, ref_loss)
    hold_tensors(tag, "gradient", grads, ref_grads)


def phase_train(net: str, n_warmup: int, n_steps: int, card: str):
    """Train ``net`` at full width (bf16 policy, the bench loss stack, Adam);
    returns each kernel's launches in the timed steps, the counts set to 0
    just before them."""
    correlation = correlation_module()
    kernels = {"corr1d": correlation.correlation1d_cuda,
               "corr1d_backward": correlation.correlation1d_backward_cuda,
               "corr2d": correlation.correlation2d_cuda,
               "corr2d_backward": correlation.correlation2d_backward_cuda}
    expect = TRAIN[net]
    _, state, step = train_setup(net, "cuda", bf16=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    batches = [train_batch((TRAIN_BATCH, TRAIN_H, TRAIN_W), g, "cuda")
               for _ in range(n_warmup + n_steps)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i, batch in enumerate(batches):
        if i == n_warmup:
            for k in kernels.values():
                k.launches = 0
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
              f"train {net} step {i}: a metric or loss is not finite: {metrics}")
    launches = {name: k.launches for name, k in kernels.items()}
    for name, per_step in expect.items():
        check(launches[name] == per_step * n_steps,
              f"train {net}: {name} launched {launches[name]} times in {n_steps} steps, "
              f"expected {per_step} per step")
    timed = times[n_warmup:]
    ms = 1e3 * sum(timed) / len(timed)
    print(f"[train {net}] densenet121 bf16, CE + Lovasz + MultiTversky + OHEM, Adam, "
          f"{TRAIN_BATCH} pairs of {TRAIN_H}x{TRAIN_W}: {ms:.2f} ms/step, "
          f"{TRAIN_BATCH / ms * 1e3:.2f} training pairs/s over {len(timed)} steps (per step: "
          f"{', '.join(f'{1e3 * t:.2f}' for t in times)} ms, the first {n_warmup} warm-ups); "
          f"losses {', '.join(f'{v:.5g}' for v in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; {card}",
          flush=True)
    return launches


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
    ap.add_argument("--train", nargs="?", const="sdnet_mini_ext", choices=sorted(TRAIN),
                    help="only train this net (the flagship by default) and time it")
    ap.add_argument("--backward", nargs="?", const="corr1d", choices=sorted(BACKWARDS),
                    help="only hold this backward kernel (corr1d's by default) against its "
                         "plain version at the training and serving shapes and time it")
    ap.add_argument("--kernels", action="store_true",
                    help="only build the kernels and hold them against their plain versions "
                         "(phases 1-2); prints no result line")
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
    if args.serve or args.train or args.backward:
        try:
            if args.serve:
                phase_serve(args.serve, SERVE_BATCHES, SERVE[args.serve][1])
            elif args.train:
                phase_train(args.train, TRAIN_WARMUP, 10, card)
            else:
                phase_backward(args.backward, None, BACKWARDS[args.backward][2][:4], autograd=False)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        sass = phase_build()
        records = {name: phase_kernel(name, sass) for name in KERNELS}
        for name in BACKWARDS:
            records[f"{name}_backward"] = phase_backward(name, sass)
        if args.kernels:
            print(json.dumps({"kernels": list(records.values())}), flush=True)
            return 0
        for net, corr_type in (("sdnet_mini_ext", "1dcorr"), ("sdnet", "2dcorr"),
                               ("sdnet_mini_ext", "2dcorr")):
            phase_small_forward(net, corr_type)
        for net in TRAIN:
            phase_small_train(net)
        records["corr1d"]["launches"] = phase_serve("sdnet_mini_ext", *SERVE["sdnet_mini_ext"])["corr1d"]
        phase_serve("sdnet", *SERVE["sdnet"])
        # each kernel's launches come from the train step of its path
        for net, names in (("sdnet_mini_ext", ("corr1d_backward",)),
                           ("sdnet", ("corr2d", "corr2d_backward"))):
            launches = phase_train(net, TRAIN_WARMUP, TRAIN_STEPS, card)
            for name in names:
                records[name]["launches"] = launches[name]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [records[k] for k in ("corr1d", "corr1d_backward", "corr2d",
                                                       "corr2d_backward")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
