"""Where the bf16 correlation kernels' time goes, on one CUDA card.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.probe_band \
        [--shape B H W C] [--variants kernel,staged-f1]
        [--backward [corr1d|corr2d]] [--out report.json]

Builds the bf16 band kernels of ``csrc/`` (corr1d, corr2d) as they are and in
variants with one part cut out, each from a copy of the sources under
``build/probe/``, and times every variant at the main path's shape,
f1 = f2 = (16, 64, 120, 352) bf16 (or ``--shape``), with CUDA events (50
launches, after a warm-up; variants in turns, twice over; ``--variants``
takes a comma-separated subset):

* ``kernel``      -- the sources as they are;
* ``no-products`` -- the tensor-core loop runs no step: staging, stores and
  barriers only, so its time is what moving the bytes takes;
* ``no-loads``    -- no f2 window is copied (f1's tile still is, once per
  block): products, stores and barriers only, on whatever the shared
  memory holds;
* ``half-copies`` -- only the first half of each stage's f2 boxes is copied
  (f1 stays resident at this shape): half the bytes from L2, the same
  products and hand-offs;
* ``no-mma``      -- each tensor-core product becomes one fp32 add (the
  fragments are still loaded with ``ldmatrix``);
* ``no-ldmatrix`` -- the fragments are register moves instead of
  ``ldmatrix`` reads of shared memory (the products still run);
* ``no-stores``   -- the bands are not written out (a test of the sums
  that never holds keeps the products alive);
* ``one-row``     -- corr2d with one output row per block instead of two,
  which stages every f2 window twice as often (twice the bytes re-read from
  L2);
* ``one-box``, ``three-box`` -- corr2d with stages of one or three
  64-channel boxes instead of six (a whole f2 row at C = 352): more, smaller
  stages in the ring, and more hand-offs per f2 row.

The variants above are wrong by construction; only their times count. The
ones below compute the same outputs another way, and their max|d| against
``kernel`` says whether they do:

* ``cp-async``    -- no tensor map: the producer warp stages every box with
  16-byte ``cp.async`` (zero-filled outside the image) into the same
  swizzled layout, completing on the same ``mbarrier``s;
* ``output-tile`` -- the bands are collected in a shared-memory output tile
  (taken from the ring's budget) and written as one span per row with
  16-byte stores, instead of straight from the accumulators;
* ``unroll-boxes`` -- corr1d with one-box stages and ``#pragma unroll 3``
  over the boxes of a stage: the same arithmetic in the source, but nvcc
  unrolls the loop with no remainder (its machine code runs three boxes for
  every test of the loop's bound), so its max|d| is the size of that fault;
* ``staged-f1``   -- the plan never keeps f1's tile resident in shared
  memory: each stage copies f1's boxes beside f2's, and the ring takes the
  room f1's tile held (the launches' own plan where f1 is staged already).

Each variant's plan at C (stages, 64-channel boxes a stage, f1 resident,
shared memory bytes) is printed beside its time. Its tensor-core
instructions (HMMA) are counted in its library's machine code
(``cuobjdump -sass``); the libraries stay under ``build/probe/<variant>/``
for a closer reading.

``--backward`` probes corr1d's bf16 backward (``corr1d_backward``, the
transposed band of ``csrc/corr1d.cu``) instead, at the training shape per
view (8, 32, 64, 352) and the serving shape (16, 64, 120, 352), each launch
timed by its own pair of CUDA events, warm (back to back) and with the L2
flushed before it (256 MB written), 30 launches of each, variants in turns,
twice over:

* ``kernel``        -- the sources as they are: one block walks all of a
  row tile's 64-channel boxes;
* ``split-2``, ``split-3``, ``split-6`` -- a row tile's boxes split over 2, 3
  or 6 blocks (more, shorter blocks; g's window and the A fragments built
  once per block);
* ``one-block``     -- one block an SM, its ring as deep as the row tile's
  boxes (all of them in flight);
* ``store-64``      -- each tensor's 4 slabs meet on a named barrier and one
  warp stores the tile's 64 columns x 64 channels (one TMA store per tensor
  and box instead of one per warp);
* ``no-products``   -- no ``ldmatrix`` and no tensor-core product: staging,
  the output boxes, stores and barriers only;
* ``no-loads``      -- no window is copied (the ring's hand-offs remain);
* ``no-stores``     -- no output box is stored (a test of the sums that never
  holds keeps them alive).

The first six compute the same gradients; the last three are wrong by
construction. ``flushed`` writes the 256 MB (the L2 is left holding dirty
lines of the flush), ``read-flushed`` reads them (a clean L2 of other data).

``--backward corr2d`` probes corr2d's bf16 backward (``corr2d_backward``,
17 row offsets of the transposed band, ``csrc/corr2d.cu``) the same way, at
the same two shapes with g of 289 channels:

* ``kernel``       -- the sources as they are (a 3-stage ring);
* ``stages-2``, ``stages-4`` -- a ring of 2 or 4 stages (4: one block an SM);
* ``no-g-reads``   -- the A fragments are built from a constant instead of
  the stage's g boxes (the band mask stays);
* ``no-g-copies``  -- g's boxes are not copied into the stages;
* ``no-loads``     -- nothing is copied (the ring's hand-offs remain);
* ``no-products``  -- no ``ldmatrix`` and no tensor-core product (the A
  fragments are still built);
* ``no-stores``    -- no slab is stored.

The first three compute the same gradients; the rest are wrong by
construction.

Prints the card's name and power limit, the nvcc release and one JSON
line, and writes the JSON to ``--out``. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _kernels

SHAPE = (16, 64, 120, 352)
PATCH = {"corr1d": (1, 17), "corr2d": (17, 17)}
STEPS = "const int ksteps = (min(kCC, C - kq * kCC) + 15) / 16;"
F2_COPY = "tma_load(st + x * kF2Box, tm2, (q0 + x) * kCC, x0 - kPW / 2, r, b, &full[s]);"
F2_BYTES = "mbar_expect_tx(&full[s], n * (kF2Box + (f1_res ? 0 : nr * kF1Box)));"
MMA = '"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "'
LDMATRIX = '"ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"'
STORE = "if (d >= 0 && d < kPW && g + m < ncols)"
BOX_LOOP = "      for (int x = 0; x < n; ++x) {\n        const int kq = q0 + x;"
# cp-async: 16-byte cp.async of 8 channels in place of copy_box's element loads
ELEMENT_COPY = """  for (int k = lane; k < cols * kCC; k += 32) {
    const int n = k / kCC;
    const int c = k % kCC;
    const int x = xb + n;
    *reinterpret_cast<bf16*>(dst + swz(n, c)) =
        (x >= 0 && x < W && c0 + c < C) ? row[(size_t)x * C + c0 + c] : __float2bfloat16(0.f);
  }"""
CP_ASYNC_COPY = """  for (int k = lane; k < cols * (kCC / 8); k += 32) {
    const int n = k / (kCC / 8);
    const int c = (k % (kCC / 8)) * 8;
    const int x = xb + n;
    const bool in = x >= 0 && x < W && c0 + c < C;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(smem_u32(dst + swz(n, c))),
                 "l"(row + (in ? (size_t)x * C + c0 + c : 0)), "r"(in ? 16 : 0) : "memory");
  }"""


def _cp_async_arrive(bar: str) -> tuple:
    # each lane's copies complete on the barrier, then the phase's one arrival
    return ("corr_band.cuh", f"if (!kTma && lane == 0) mbar_arrive({bar});",
            f'asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\\n" '
            f'::"r"(smem_u32({bar})) : "memory"); __syncwarp(); '
            f"if (lane == 0) mbar_arrive({bar});")


def _tile_launch(src: str, plan: str, tile: str) -> tuple:
    # the output tile's bytes come out of the ring's budget and onto the launch
    return ((src, plan, plan.replace(");", f" - ({tile}));")),
            (src, "(int)p.smem);", f"(int)(p.smem + {tile}));"),
            (src, "p.smem, stream>>>", f"p.smem + {tile}, stream>>>"))


TILE1 = "band::kTX * band::kPW * 2 + 16"
TILE2 = "kRows * band::kTX * kPatch * 2 + 16"
OUTPUT_TILE = (
    ("corr_band.cuh", "  uint64_t* f1bar = empty + kMaxStages;\n",
     "  uint64_t* f1bar = empty + kMaxStages;\n"
     "  bf16* otile = reinterpret_cast<bf16*>(f1bar + 2);  // kR x 64 pixels x P\n"),
    ("corr_band.cuh", "  __syncthreads();\n\n  if (warp == kConsumers) {",
     "  for (int k = threadIdx.x; k < kR * kTX * P; k += kThreads) otile[k] = __float2bfloat16(0.f);\n"
     "  __syncthreads();\n\n  if (warp == kConsumers) {"),
    ("corr_band.cuh", "out[((size_t)(y0 + a) * W + x0 + g + m) * P + i * kPW + d] =",
     "otile[(a * kTX + g + m) * P + i * kPW + d] ="),
    ("corr_band.cuh", "\n}\n\n}  // namespace band",
     """
  __syncthreads();
  for (int a = 0; a < nr; ++a) {  // each row's band: one span of the output
    bf16* o = out + ((size_t)(y0 + a) * W + x0) * P;
    const bf16* t = otile + a * kTX * P;
    const int len = ncols * P, vec = W % 8 == 0 ? len / 8 : 0;
    for (int k = threadIdx.x; k < vec; k += kThreads)
      reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(t)[k];
    for (int k = 8 * vec + threadIdx.x; k < len; k += kThreads) o[k] = t[k];
  }
}

}  // namespace band"""),
)
# variant -> kernels it applies to, and (file, text, replacement) edits
VARIANTS = {
    "kernel": (("corr1d", "corr2d"), ()),
    "no-products": (("corr1d", "corr2d"),
                    (("corr_band.cuh", STEPS, "const int ksteps = 0;"),)),
    "no-loads": (("corr1d", "corr2d"), (("corr_band.cuh", F2_COPY, ";"),
                                        ("corr_band.cuh", F2_BYTES, "mbar_arrive(&full[s]);"))),
    "half-copies": (("corr1d", "corr2d"),
                    (("corr_band.cuh", F2_COPY, "if (x < n / 2) " + F2_COPY),
                     ("corr_band.cuh", F2_BYTES, "mbar_expect_tx(&full[s], (n / 2) * kF2Box);"))),
    # the rest of the asm line becomes a comment; the fragments stay live
    "no-mma": (("corr1d", "corr2d"), (("corr_band.cuh", MMA, '"add.f32 %0, %0, %1; // "'),)),
    "no-ldmatrix": (("corr1d", "corr2d"),
                    (("corr_band.cuh", LDMATRIX,
                      '"mov.b32 %0, %4; mov.b32 %1, %4; mov.b32 %2, %4; mov.b32 %3, %4;\\n"'),)),
    "no-stores": (("corr1d", "corr2d"),
                  (("corr_band.cuh", STORE, STORE[:-1] + " && acc[a][t][e] == 1.5e-38f)"),)),
    "one-row": (("corr2d",), (("corr2d.cu", "constexpr int kRows = 2;",
                               "constexpr int kRows = 1;"),)),
    "one-box": (("corr2d",), (("corr2d.cu", "constexpr int kBoxes = 6;",
                               "constexpr int kBoxes = 1;"),)),
    "three-box": (("corr2d",), (("corr2d.cu", "constexpr int kBoxes = 6;",
                                 "constexpr int kBoxes = 3;"),)),
    "cp-async": (("corr1d", "corr2d"), (
        ("corr_band.cuh", ELEMENT_COPY, CP_ASYNC_COPY),
        _cp_async_arrive("f1bar"), _cp_async_arrive("&full[s]"),
        ("corr1d.cu", "auto kernel = vec ? corr1d_band_kernel<true> : corr1d_band_kernel<false>;",
         "auto kernel = corr1d_band_kernel<false>;"),
        ("corr2d.cu", "auto kernel = vec ? corr2d_band_kernel<true> : corr2d_band_kernel<false>;",
         "auto kernel = corr2d_band_kernel<false>;"))),
    "output-tile": (("corr1d", "corr2d"), OUTPUT_TILE
                    + _tile_launch("corr1d.cu", "band::plan(C, 1, kBoxes, kSmemBudget);", TILE1)
                    + _tile_launch("corr2d.cu", "band::plan(C, kRows, kBoxes, band::kSmemMax);",
                                   TILE2)),
    "staged-f1": (("corr1d", "corr2d"), (("corr_band.cuh", "for (int res = 1; res >= 0; --res) {",
                                          "for (int res = 0; res >= 0; --res) {"),)),
    "unroll-boxes": (("corr1d",), (
        ("corr1d.cu", "constexpr int kBoxes = 3;", "constexpr int kBoxes = 1;"),
        ("corr_band.cuh", BOX_LOOP, "#pragma unroll 3\n" + BOX_LOOP))),
}


# corr1d's backward: variant -> (file, text, replacement) edits
BWD_PRODUCTS = "#pragma unroll\n    for (int ks = 0; ks < 2; ++ks)\n#pragma unroll\n      for (int np"
BWD_LOADS = ("mbar_expect_tx(&full[s], 2 * kWinBox);\n"
             "          tma_load(st, &tm1, c0, x0 - kHalo, y, b, &full[s]);\n"
             "          tma_load(st + kWinBox, &tm2, c0, x0 - kHalo, y, b, &full[s]);")
BWD_STORE = "tma_store(t == 0 ? &td1 : &td2, ob, c0, x0 + 16 * m, y, b);"
# store-64: the 4 warps of a tensor meet on a named barrier and one of them
# stores the tile's 64 columns x 64 channels
BWD_STORE_64 = (
    ("corr1d.cu", "    if (x0 + 16 * m >= W) continue;  // the whole slab lies past the image\n", ""),
    ("corr1d.cu", "      if (lane == 0) bulk_wait_read<1>();  // the store of box j - 2 has read ob\n"
                  "      __syncwarp();",
     "      if (m == 0 && lane == 0) bulk_wait_read<1>();\n"
     "      asm volatile(\"bar.sync %0, 128;\\n\" ::\"r\"(2 + t) : \"memory\");"),
    ("corr1d.cu", "      fence_async_shared();\n      __syncwarp();\n      if (lane == 0) {\n        " + BWD_STORE,
     "      fence_async_shared();\n"
     "      asm volatile(\"bar.sync %0, 128;\\n\" ::\"r\"(2 + t) : \"memory\");\n"
     "      if (m == 0 && lane == 0) {\n"
     "        tma_store(t == 0 ? &td1 : &td2, ob, c0, x0, y, b);"),
    ("corr1d.cu", "band::tensor_map(&td1, df1, B, H, W, C, kSlab);",
     "band::tensor_map(&td1, df1, B, H, W, C, band::kTX);"),
    ("corr1d.cu", "band::tensor_map(&td2, df2, B, H, W, C, kSlab);",
     "band::tensor_map(&td2, df2, B, H, W, C, band::kTX);"),
)
BWD_VARIANTS = {
    "kernel": (),
    **{f"split-{n}": (("corr1d.cu", "constexpr int kGroups = 1;", f"constexpr int kGroups = {n};"),)
       for n in (2, 3, 6)},
    "one-block": (("corr1d.cu", "while (ns > 1 && smem_bytes(ns) > kSmemBudget) --ns;",
                   "while (ns > 1 && smem_bytes(ns) > band::kSmemMax) --ns;"),),
    "store-64": BWD_STORE_64,
    "no-products": (("corr1d.cu", BWD_PRODUCTS,
                     "    for (int ks = 0; ks < 0; ++ks)\n#pragma unroll\n      for (int np"),),
    "no-loads": (("corr1d.cu", BWD_LOADS, "mbar_arrive(&full[s]);"),),
    "no-stores": (("corr1d.cu", BWD_STORE, "if (acc[0][0] == 1.5e-38f) " + BWD_STORE),),
}
BWD_SHAPES = {"train": (8, 32, 64, 352), "serve": (16, 64, 120, 352)}
# corr2d's backward: variant -> (file, text, replacement) edits
BWD2_EXPECT = "mbar_expect_tx(&full[s], in1 * (kWinBox + kGBox) + in2 * kWinBox + kGBox);"
BWD2_F_LOADS = ("          if (in1) tma_load(st, &tm1, c0, x0 - kHalo, r1, b, &full[s]);\n"
                "          if (in2) tma_load(st + kWinBox, &tm2, c0, x0 - kHalo, r2, b, &full[s]);\n")
BWD2_G_LOADS = ("          tma_load(g1, &tmg, i * kPW & ~7, x0 - kHalo, y, b, &full[s]);\n"
                "          if (in1) tma_load(g2, &tmg, i * kPW & ~7, x0 - kHalo, r1, b, &full[s]);\n")
BWD2_A = "v[e] = t == 0 ? ga[(r + kHalo) * kGC + dd] : ga[kk * kGC + kPW - 1 - dd];"
BWD2_PRODUCTS = "      const uint32_t bx = smem_u32(st + (t == 0 ? kWinBox : 0));"
BWD2_STAGES = "constexpr int kStages = 3;"
BWD2_STORE = "tma_store(t == 0 ? &td1 : &td2, ob, c0, x0 + 16 * m, y, b);"
BWD2_VARIANTS = {
    "kernel": (),
    **{f"stages-{n}": (("corr2d.cu", BWD2_STAGES, f"constexpr int kStages = {n};"),) for n in (2, 4)},
    "no-g-reads": (("corr2d.cu", BWD2_A, "v[e] = __float2bfloat16(0.5f);"),),
    "no-g-copies": (("corr2d.cu", BWD2_G_LOADS, ""),
                    ("corr2d.cu", BWD2_EXPECT, "mbar_expect_tx(&full[s], (in1 + in2) * kWinBox);")),
    "no-loads": (("corr2d.cu", BWD2_G_LOADS, ""), ("corr2d.cu", BWD2_F_LOADS, ""),
                 ("corr2d.cu", BWD2_EXPECT, "mbar_arrive(&full[s]);")),
    # the A fragments stay live: their sum feeds one accumulator
    "no-products": (("corr2d.cu", BWD2_PRODUCTS,
                     "      uint32_t z = 0;\n      for (int q = 0; q < 8; ++q) "
                     "z ^= afrag[q / 4][q % 4];\n      acc[0][0] += __uint_as_float(z);\n"
                     "      if (false) {\n" + BWD2_PRODUCTS),
                    ("corr2d.cu", "          mma_bf16(acc[2 * np + 1], afrag[ks], bfrag[2], bfrag[3]);\n"
                                  "        }\n",
                     "          mma_bf16(acc[2 * np + 1], afrag[ks], bfrag[2], bfrag[3]);\n"
                     "        }\n      }\n")),
    "no-stores": (("corr2d.cu", BWD2_STORE, "if (acc[0][0] == 1.5e-38f) " + BWD2_STORE),),
}
# kernel -> (variants, g's values a pixel as the C function takes them: corr2d's
# bf16 g comes padded to 296, as its wrapper pads it)
BWD_KERNELS = {"corr1d": (BWD_VARIANTS, 17), "corr2d": (BWD2_VARIANTS, 296)}


def build_variants(variants: dict, prefix: str = "") -> dict:
    """(variant, kernel) -> loaded library; one nvcc per library, all at once.
    ``variants``: name -> (kernels, edits)."""
    root = _kernels.BUILD / "probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, (kernels, edits) in variants.items():
        src = root / (prefix + name)
        shutil.copytree(_kernels.CSRC, src)
        for fname, text, repl in edits:
            path = src / fname
            body = path.read_text()
            if text not in body:
                raise RuntimeError(f"variant {name}: {fname} no longer has {text!r}")
            path.write_text(body.replace(text, repl))
        for k in kernels:
            lib = src / f"lib{k}.so"
            cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(src / _kernels.SOURCES[k])]
            procs[(name, k)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {key} failed:\n{log}")
        libs[key] = (ctypes.CDLL(str(lib)), lib)
    return libs


def sass(lib: Path) -> str:
    """A library's machine code."""
    cuobjdump = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_times_ms(fn, iters: int, flush: torch.Tensor = None, read: bool = False) -> list:
    """Each launch of ``fn`` timed by its own pair of events, after a
    warm-up, behind a ~0.2 ms spin of the card (so the launch waits on the
    card, not on the host); ``flush`` (a large tensor) is zeroed, or with
    ``read`` summed, before each launch."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.sum() if read else flush.zero_()
        torch.cuda._sleep(400_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def probe_backward(card: str, nvcc: str, kernel: str = "corr1d") -> dict:
    """Time the bf16 backward of ``kernel`` (corr1d, corr2d) and its variants
    at the training and serving shapes, warm and with the L2 flushed;
    returns the report."""
    variants, g_values = BWD_KERNELS[kernel]
    libs = build_variants({name: ((kernel,), edits) for name, edits in variants.items()},
                          prefix="bwd-")
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    stream = torch.cuda.current_stream().cuda_stream
    times, diff = {}, {}
    for tag, shape in BWD_SHAPES.items():
        b, h, w, c = shape
        f1, f2 = (torch.randn(shape, device="cuda", generator=g).bfloat16() for _ in range(2))
        grad = torch.randn((b, h, w, g_values), device="cuda", generator=g).bfloat16()
        outs = {}
        for _ in range(2):
            for (name, _), (lib, _) in libs.items():
                fn = getattr(lib, f"{kernel}_backward")
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                df = outs.setdefault(name, (torch.zeros_like(f1), torch.zeros_like(f2)))

                def call():
                    err = fn(f1.data_ptr(), f2.data_ptr(), grad.data_ptr(), df[0].data_ptr(),
                             df[1].data_ptr(), b, h, w, c, 1, 1, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: cudaError {err}")

                for mode, fl, read in (("warm", None, False), ("flushed", flush, False),
                                       ("read-flushed", flush, True)):
                    ts = sorted(event_times_ms(call, 30, fl, read))
                    times.setdefault(f"{tag} {mode} {name}", []).append(
                        {"mean": sum(ts) / len(ts), "median": ts[len(ts) // 2]})
        for name, df in outs.items():
            diff[f"{tag} {name}"] = max((a.float() - r.float()).abs().max().item()
                                        for a, r in zip(df, outs["kernel"]))
        del f1, f2, grad, outs
    hmma = {name: sass(path).count("HMMA") for (name, _), (_, path) in libs.items()}
    for key, ts in times.items():
        tag, _, name = key.split(" ", 2)
        print(f"[probe_band {kernel} backward] {key}: mean {', '.join(f'{t["mean"]:.4f}' for t in ts)} ms, "
              f"median {', '.join(f'{t["median"]:.4f}' for t in ts)} ms, max|d| vs kernel "
              f"{diff[f'{tag} {name}']:.4g}, {hmma[name]} HMMA in the library", flush=True)
    report = {"card": card, "nvcc": nvcc, "kernel": f"{kernel}_backward", "shapes": BWD_SHAPES,
              "dtype": "bfloat16", "ms": times,
              "max_abs_diff_vs_kernel": diff, "hmma": hmma}
    print(json.dumps(report), flush=True)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--backward", nargs="?", const="corr1d", choices=sorted(BWD_KERNELS),
                    help="probe a bf16 backward kernel (corr1d's by default) instead of the "
                         "forward kernels")
    ap.add_argument("--shape", type=int, nargs=4, default=SHAPE, metavar=("B", "H", "W", "C"),
                    help="the forward probe's f1 = f2 shape (NHWC)")
    ap.add_argument("--variants", default=None,
                    help="the forward variants to time, comma-separated (all by default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_band: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    nvcc = subprocess.run([_kernels._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-2]
    print(nvcc, flush=True)
    if args.backward:
        report = probe_backward(card, nvcc, args.backward)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown or "kernel" not in names:
        ap.error(f"--variants: unknown {unknown}, or no 'kernel' to hold the others against")
    libs = build_variants({n: VARIANTS[n] for n in names})
    shape = tuple(args.shape)
    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(shape, device="cuda", generator=g).bfloat16()
    f2 = torch.randn(shape, device="cuda", generator=g).bfloat16()
    b, h, w, c = shape
    stream = torch.cuda.current_stream().cuda_stream
    plans = {}  # each variant's plan at C: stages, boxes a stage, f1 resident, smem bytes
    for (name, k), (lib, _) in libs.items():
        fn = getattr(lib, f"{k}_forward_plan")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
        plan = (ctypes.c_int * 4)()
        fn(c, plan)
        plans[f"{k} {name}"] = list(plan)
    outs, times = {}, {}
    for _ in range(2):
        for (name, k), (lib, _) in libs.items():
            fn = getattr(lib, f"{k}_forward")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            ph, pw = PATCH[k]
            out = outs.setdefault((name, k), torch.zeros((b, h, w, ph * pw), dtype=torch.bfloat16,
                                                         device="cuda"))

            def call():
                err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, ph, pw, 1, 1,
                         stream)
                if err != 0:
                    raise RuntimeError(f"{name} {k}: cudaError {err}")

            times.setdefault(f"{k} {name}", []).append(time_ms(call))
    # how far each variant's output lies from the kernel's (NaN where a
    # variant leaves garbage in shared memory)
    diff = {f"{k} {name}": (out.float() - outs[("kernel", k)].float()).abs().max().item()
            for (name, k), out in outs.items()}
    hmma = {f"{k} {name}": sass(path).count("HMMA") for (name, k), (_, path) in libs.items()}
    report = {"card": card, "nvcc": nvcc, "shape": list(shape), "dtype": "bfloat16", "ms": times,
              "max_abs_diff_vs_kernel": diff, "hmma": hmma, "plan": plans}
    for key, ms in times.items():
        print(f"[probe_band] {key}: {', '.join(f'{t:.4f}' for t in ms)} ms, max|d| vs kernel "
              f"{diff[key]:.4g}, {hmma[key]} HMMA, plan {plans[key]}", flush=True)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
