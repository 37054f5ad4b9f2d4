"""Where the bf16 correlation kernels' time goes, on one CUDA card.

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.tools.probe_band \
        [--shape B H W C] [--variants kernel,staged-f1]
        [--backward [corr1d|corr2d]] [--fp32 [corr2d|corr1d]] [--out report.json]

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
``csrc/corr2d.cu``: g's relayout into slices, then the persistent band over
4 output rows and 128 channels an item) the same way, at the same two
shapes with g of 289 channels and each variant's own workspace:

* ``kernel``       -- the sources as they are (a 7-stage ring);
* ``stages-3`` .. ``stages-6`` -- a ring of 3 to 6 stages;
* ``rows-2``, ``rows-3`` -- items of 2 or 3 output rows instead of 4 (each F
  window copied (R + 16) / R times);
* ``producer-warp`` -- one producer warp (9 warps) instead of a producer
  warpgroup that gives its registers to the consumers (``setmaxnreg``);
* ``no-g-reads``   -- the A fragments are built from a constant instead of
  the stage's slices (the band mask stays);
* ``no-relayout``  -- the relayout is not launched (the band reads a stale
  workspace): the band's time alone;
* ``no-band``      -- the band is not launched: the relayout's time alone;
* ``no-g-copies``  -- no slice is copied into the stages;
* ``no-loads``     -- nothing is copied (the ring's hand-offs remain);
* ``no-products``  -- no ``ldmatrix`` and no tensor-core product (the A
  fragments are still loaded);
* ``no-compute``   -- the warps only wait for and release each stage, and
  store;
* ``no-stores``    -- no output is stored.

The first eight compute the same gradients; the rest are wrong by
construction.

``--fp32 corr1d`` probes corr1d's fp32 forward (``corr1d_fp32_kernel``,
``csrc/corr_tile.cuh``) at the training step's (8, 32, 64, 352), an eval
row's (1, 64, 120, 352) and the serving shape (16, 64, 120, 352) (or
``--shape``), each launch timed alone by its own events behind a card-side
spin, warm, 30 launches, variants in turns, twice over:

* ``kernel``      -- the sources as they are (a 4-stage ring, 3 blocks an SM);
* ``stages-3``, ``stages-6`` -- a ring of 3 stages (4 blocks an SM) or 6
  (2 blocks an SM);
* ``lanes-16``    -- 16 lanes a column group and 64-channel stages (256
  threads, a 3-stage ring, 2 blocks an SM);
* ``tile-32``     -- 32-column row tiles (twice the blocks; f2's halo read
  1.5 times);
* ``prefetch-l2`` -- one bulk L2 prefetch of the tile's f1 and f2 pixels
  before the ring's copies;
* ``l2-256b``     -- each ``cp.async`` asks the L2 for 256 bytes on a miss;
* ``no-loads``    -- no global read: the ring is written with zeros;
* ``no-products`` -- no product nor its shared-memory reads: the copies,
  barriers and stores;
* ``no-stores``   -- the outputs are not stored.

The first seven compute the same outputs; the last three are wrong by
construction.

Prints the card's name and power limit, the nvcc release and one JSON
line, and writes the JSON to ``--out``. Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
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
BWD2_EXPECT = "mbar_expect_tx(&full[s], (kTma ? nbox * kWinBox : 0) + rows * kSliceBytes);"
BWD2_BOX_LOADS = "          if (kTma)\n            for (int q = 0; q < nbox; ++q)\n              tma_load("
BWD2_SLICE_LOADS = "            if (i >= 0 && i < kPH)\n              bulk_load("
BWD2_A = ("              afrag[a][0] = w[0] & m0;\n              afrag[a][1] = 0u;\n"
          "              afrag[a][2] = w[4];\n              afrag[a][3] = w[kRow8 + 4] & m0;\n"
          "            } else {\n              afrag[a][0] = w[8] & m16;\n"
          "              afrag[a][1] = w[kRow8 + 8];\n              afrag[a][2] = 0u;\n"
          "              afrag[a][3] = w[kRow8 + 12] & m16;\n")
BWD2_LDMATRIX = "ldmatrix_x4_trans(bfrag[np], bx + boff[np] + 2048 * ks);"
BWD2_MMA = "            if (!on[a]) continue;"
BWD2_STAGES = "constexpr int kStages = 7;"
BWD2_ROWS = "constexpr int kR = 4;"
BWD2_STORE = "if (a < it.nr && x < W && c < C) {"
BWD2_RELAYOUT = "  corr2d_bwd_relayout_kernel<T><<<"
BWD2_BAND = "  kernel<<<grid, kThreads, kSmem, stream>>>("
BWD2_COMPUTE = "      if (live) {\n        const unsigned char* st = ring"
BWD2_VARIANTS = {
    "kernel": (),
    **{f"stages-{n}": (("corr2d.cu", BWD2_STAGES, f"constexpr int kStages = {n};"),)
       for n in (3, 4, 5, 6)},
    **{f"rows-{n}": (("corr2d.cu", BWD2_ROWS, f"constexpr int kR = {n};"),) for n in (2, 3)},
    # the workspace is left as it is: wrong by construction, the band's time alone
    # a producer warp instead of a warpgroup, no setmaxnreg: 9 warps
    "producer-warp": (
        ("corr2d.cu", "constexpr int kThreads = 32 * (4 + kConsumers);",
         "constexpr int kThreads = 32 * (1 + kConsumers);"),
        ("corr2d.cu", '  if (threadIdx.x < 128) {\n    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" '
                      '::"n"(kProducerRegs));\n    if (threadIdx.x >= 32) return;\n',
         "  if (threadIdx.x < 32) {\n"),
        ("corr2d.cu", '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', ""),
        ("corr2d.cu", "  const int warp = (threadIdx.x >> 5) - 4;", "  const int warp = (threadIdx.x >> 5) - 1;")),
    "no-relayout": (("corr2d.cu", BWD2_RELAYOUT, "  if (false) corr2d_bwd_relayout_kernel<T><<<"),),
    "no-band": (("corr2d.cu", BWD2_BAND, "  if (false) " + BWD2_BAND.lstrip()),),
    # the consumers wait and release each stage and store, nothing else
    "no-compute": (("corr2d.cu", BWD2_COMPUTE, BWD2_COMPUTE.replace("if (live)", "if (false)")),),
    "no-g-reads": (("corr2d.cu", BWD2_A, re.sub(r"w\[[^]]+\]", "0x3f803f80u", BWD2_A)),),
    "no-g-copies": (("corr2d.cu", BWD2_SLICE_LOADS, BWD2_SLICE_LOADS.replace("i >= 0", "false")),
                    ("corr2d.cu", BWD2_EXPECT, "mbar_expect_tx(&full[s], kTma ? nbox * kWinBox : 0);")),
    "no-loads": (("corr2d.cu", BWD2_SLICE_LOADS, BWD2_SLICE_LOADS.replace("i >= 0", "false")),
                 ("corr2d.cu", BWD2_BOX_LOADS, BWD2_BOX_LOADS.replace("if (kTma)", "if (false)")),
                 ("corr2d.cu", BWD2_EXPECT, "mbar_arrive(&full[s]);")),
    # the A fragments stay live: a test on them that never holds guards the products
    "no-products": (("corr2d.cu", BWD2_LDMATRIX, "if (false) " + BWD2_LDMATRIX),
                    ("corr2d.cu", BWD2_MMA, BWD2_MMA.replace(
                        "!on[a]", "!on[a] || afrag[a][0] != 0x7fc17fc1u"))),
    "no-stores": (("corr2d.cu", BWD2_STORE, BWD2_STORE[:-3] + " && acc[a][n][2 * hh] == 1.5e-38f) {"),),
}
# kernel -> (variants, g's values a pixel, whether the C function takes a
# workspace after df2)
BWD_KERNELS = {"corr1d": (BWD_VARIANTS, 17, False), "corr2d": (BWD2_VARIANTS, 289, True)}

# corr2d's fp32 forward (corr2d_fp32_kernel): variant -> (file, text, replacement) edits
FWD32_STAGES = "constexpr int kStages = 2;"
FWD32_UNITS = "        {\n          const float4* s2"
FWD32_EDGES = "        {\n          // the edge's shifts"
FWD32_COPY = "    cp_async16(dst, src, in);"
FWD32_STORE = "          for (int n = lane; n < len[a]; n += 32) o[n] = src[n];"
FWD32_VARIANTS = {
    "kernel": (),
    "stages-3": (("corr2d.cu", FWD32_STAGES, "constexpr int kStages = 3;"),),
    # the ring's copies and barriers, f1's loads and the stores; no product
    "no-products": (("corr2d.cu", FWD32_UNITS, "        if (false)" + FWD32_UNITS[8:]),
                    ("corr2d.cu", FWD32_EDGES, "        if (false)" + FWD32_EDGES[8:])),
    # the full units' products only: the edge units' shares cut out
    "no-edges": (("corr2d.cu", FWD32_EDGES, "        if (false)" + FWD32_EDGES[8:]),),
    # no copy into the ring (its barriers remain): the products on whatever it holds
    "no-loads": (("corr2d.cu", FWD32_COPY, "    if (false) cp_async16(dst, src, in);"),),
    # the staged outputs are not written out (a test that never holds keeps them)
    "no-stores": (("corr2d.cu", FWD32_STORE, FWD32_STORE.replace(
        "o[n] = src[n];", "if (src[n] == 1.5e-38f) o[n] = src[n];")),),
}
# corr2d's fp32 backward (the relayout in fp32, then corr2d_bwd_fp32_kernel)
BWD32_STAGES = "constexpr int kStages32 = 3;"
BWD32_BAND = "  kernel<<<grid, kThreads32, kSmem32, stream>>>("
BWD32_COMPUTE = "    if (live) {\n      const float4* st = ring_b32"
BWD32_WIN_COPY = "      cp_async16(st + n, src, in);"
BWD32_SLICE_COPY = "      cp_async16(st + kWinChunks + a * kSliceChunks + n, src + n, true);"
BWD32_STORE = "                *reinterpret_cast<float4*>(o) = make_float4("
BWD32_VARIANTS = {
    "kernel": (),
    "stages-2": (("corr2d.cu", BWD32_STAGES, "constexpr int kStages32 = 2;"),),
    # the workspace is left as it is: wrong by construction, the band's time alone
    "no-relayout": (("corr2d.cu", BWD2_RELAYOUT, "  if (false) corr2d_bwd_relayout_kernel<T><<<"),),
    "no-band": (("corr2d.cu", BWD32_BAND, "  if (false) " + BWD32_BAND.lstrip()),),
    # the warps wait for and release each stage and store, nothing else
    "no-products": (("corr2d.cu", BWD32_COMPUTE, BWD32_COMPUTE.replace("if (live)", "if (false)")),),
    "no-loads": (("corr2d.cu", BWD32_WIN_COPY, "      if (false) cp_async16(st + n, src, in);"),
                 ("corr2d.cu", BWD32_SLICE_COPY, "      if (false) " + BWD32_SLICE_COPY.lstrip())),
    "no-stores": (("corr2d.cu", BWD32_STORE,
                   "                if (acc[a][x][4 * t] == 1.5e-38f) "
                   "*reinterpret_cast<float4*>(o) = make_float4("),),
}


# corr1d's fp32 forward (corr_tile.cuh's corr1d_fp32_kernel): variant -> edits
def _tile_consts(**values) -> tuple:
    # corr_tile.cuh's constants of the forward set to other values
    now = {"kTX": 64, "kCG": 8, "kStages": 4, "kBlocksPerSM": 3}
    return tuple(("corr_tile.cuh", f"constexpr int {k} = {now[k]};", f"constexpr int {k} = {v};")
                 for k, v in values.items())


FWD1_32_COPY = "      cp_async16(st + i, src, in);"
FWD1_32_NST = "  const int nst = (C + kCS - 1) / kCS;\n"
FWD1_32_PREFETCH = """  if (kVec && threadIdx.x == 0) {
    const int a = max(0, x0 - kHalo), e1 = min(W, x0 + kTX), e2 = min(W, x0 + kTX + kHalo);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(r1 + (size_t)x0 * C),
                 "r"((e1 - x0) * C * 4) : "memory");
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(r2 + (size_t)a * C),
                 "r"((e2 - a) * C * 4) : "memory");
  }
"""
FWD1_32_PRODUCTS = "    for (int w = 0; w < kXPT + kPW - 1; ++w) {"
FWD1_32_STORE = "o[i] = tile[i];"
FWD1_32_VARIANTS = {
    "kernel": (),
    # a shallower or deeper ring: more or fewer blocks an SM (shared memory
    # and registers allowing)
    "stages-3": _tile_consts(kStages=3, kBlocksPerSM=4),
    "stages-6": _tile_consts(kStages=6, kBlocksPerSM=2),
    # 16 lanes a column group, 64-channel stages: 256 threads, 2 blocks an SM
    "lanes-16": _tile_consts(kCG=16, kStages=3, kBlocksPerSM=2),
    # 32-column row tiles: twice the blocks, f2's halo read 1.5 times
    "tile-32": _tile_consts(kTX=32, kBlocksPerSM=5),
    # one bulk L2 prefetch of the tile's f1 and f2 pixels (contiguous runs of
    # whole pixels) before the ring's copies
    "prefetch-l2": (("corr_tile.cuh", FWD1_32_NST, FWD1_32_NST + FWD1_32_PREFETCH),),
    # each cp.async asks the L2 for 256 bytes on a miss (the next stage's quads)
    "l2-256b": (("corr_band.cuh", "cp.async.cg.shared.global [%0]",
                 "cp.async.cg.shared.global.L2::256B [%0]"),),
    # no global read: the ring is written with zeros (its barriers remain)
    "no-loads": (("corr_tile.cuh", FWD1_32_COPY,
                  "      st[i] = make_float4(0.f, 0.f, 0.f, 0.f);"),),
    # the copies, barriers and stores; no product (nor its shared-memory reads)
    "no-products": (("corr_tile.cuh", FWD1_32_PRODUCTS, "    for (int w = 0; w < 0; ++w) {"),),
    # the outputs are not stored (a test that never holds keeps the sums)
    "no-stores": (("corr_tile.cuh", FWD1_32_STORE, "if (tile[i] == 1.5e-38f) o[i] = tile[i];"),),
}
FWD1_32_SHAPES = {"train": (8, 32, 64, 352), "eval row": (1, 64, 120, 352), "serve": (16, 64, 120, 352)}


def apply_edits(name: str, edits, read) -> dict:
    """The sources of variant ``name`` after its (file, text, replacement)
    edits in turn, file -> text; ``read(file)`` gives today's source. Raises
    when a text is no longer there."""
    files = {}
    for fname, text, repl in edits:
        body = files.get(fname, None) or read(fname)
        if text not in body:
            raise RuntimeError(f"variant {name}: {fname} no longer has {text!r}")
        files[fname] = body.replace(text, repl)
    return files


def all_variants() -> dict:
    """Every probe variant, forward and backward: "table variant" -> edits."""
    out = {f"forward {n}": edits for n, (_, edits) in VARIANTS.items()}
    for kernel, (variants, _, _) in BWD_KERNELS.items():
        out.update({f"{kernel}-backward {n}": edits for n, edits in variants.items()})
    out.update({f"fp32 forward {n}": edits for n, edits in FWD32_VARIANTS.items()})
    out.update({f"fp32 corr2d-backward {n}": edits for n, edits in BWD32_VARIANTS.items()})
    out.update({f"fp32 corr1d-forward {n}": edits for n, edits in FWD1_32_VARIANTS.items()})
    return out


def build_variants(variants: dict, prefix: str = "") -> dict:
    """(variant, kernel) -> loaded library; one nvcc per library, all at once.
    ``variants``: name -> (kernels, edits)."""
    root = _kernels.BUILD / "probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, (kernels, edits) in variants.items():
        src = root / (prefix + name)
        shutil.copytree(_kernels.CSRC, src)
        for fname, body in apply_edits(name, edits, lambda f: (src / f).read_text()).items():
            (src / fname).write_text(body)
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


def probe_backward(card: str, nvcc: str, kernel: str = "corr1d", fp32: bool = False) -> dict:
    """Time the bf16 backward of ``kernel`` (corr1d, corr2d; ``fp32``:
    corr2d's fp32 backward) and its variants at the training and serving
    shapes, warm and with the L2 flushed; returns the report."""
    variants, g_values, takes_work = BWD_KERNELS[kernel]
    if fp32:
        variants = BWD32_VARIANTS
    dtype = torch.float32 if fp32 else torch.bfloat16
    libs = build_variants({name: ((kernel,), edits) for name, edits in variants.items()},
                          prefix="bwd-")
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB
    stream = torch.cuda.current_stream().cuda_stream
    times, diff = {}, {}
    for tag, shape in BWD_SHAPES.items():
        b, h, w, c = shape
        f1, f2 = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(2))
        grad = torch.randn((b, h, w, g_values), device="cuda", generator=g).to(dtype)
        outs, works = {}, {}
        for _ in range(2):
            for (name, _), (lib, _) in libs.items():
                fn = getattr(lib, f"{kernel}_backward")
                fn.argtypes = ([ctypes.c_void_p] * (6 if takes_work else 5) + [ctypes.c_int] * 6
                               + [ctypes.c_void_p])
                df = outs.setdefault(name, (torch.zeros_like(f1), torch.zeros_like(f2)))
                work = ()
                if takes_work:  # each variant's own workspace, as its wrapper allocates it
                    size = getattr(lib, f"{kernel}_backward_workspace")
                    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_size_t
                    work = (works.setdefault(name, torch.empty(size(b, h, w, c, int(not fp32)),
                                                               dtype=torch.uint8,
                                                               device="cuda")).data_ptr(),)

                def call():
                    err = fn(f1.data_ptr(), f2.data_ptr(), grad.data_ptr(), df[0].data_ptr(),
                             df[1].data_ptr(), *work, b, h, w, c, int(not fp32), 1, stream)
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
        del f1, f2, grad, outs, works
    hmma = {name: sass(path).count("HMMA") for (name, _), (_, path) in libs.items()}
    for key, ts in times.items():
        tag, _, name = key.split(" ", 2)
        print(f"[probe_band {kernel} backward {str(dtype)[6:]}] {key}: mean {', '.join(f'{t["mean"]:.4f}' for t in ts)} ms, "
              f"median {', '.join(f'{t["median"]:.4f}' for t in ts)} ms, max|d| vs kernel "
              f"{diff[f'{tag} {name}']:.4g}, {hmma[name]} HMMA in the library", flush=True)
    report = {"card": card, "nvcc": nvcc, "kernel": f"{kernel}_backward", "shapes": BWD_SHAPES,
              "dtype": str(dtype)[6:], "ms": times,
              "max_abs_diff_vs_kernel": diff, "hmma": hmma}
    print(json.dumps(report), flush=True)
    return report


def probe_fwd1_fp32(card: str, nvcc: str, shapes: dict, names) -> dict:
    """Time corr1d's fp32 forward and its variants (``names`` of
    ``FWD1_32_VARIANTS``) at ``shapes``, each launch alone (its own events
    behind a card-side spin), warm, 30 launches, variants in turns, twice
    over; returns the report."""
    libs = build_variants({n: (("corr1d",), FWD1_32_VARIANTS[n]) for n in names}, prefix="fwd1-")
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    times, diff = {}, {}
    for tag, shape in shapes.items():
        b, h, w, c = shape
        f1, f2 = (torch.randn(shape, device="cuda", generator=g) for _ in range(2))
        outs = {}
        for _ in range(2):
            for (name, _), (lib, _) in libs.items():
                fn = lib.corr1d_forward
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                out = outs.setdefault(name, torch.zeros((b, h, w, 17), device="cuda"))

                def call():
                    err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, 1, 17, 0, 1, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: cudaError {err}")

                ts = sorted(event_times_ms(call, 30))
                times.setdefault(f"{tag} {name}", []).append(
                    {"mean": sum(ts) / len(ts), "median": ts[len(ts) // 2]})
        for name, out in outs.items():
            diff[f"{tag} {name}"] = (out - outs["kernel"]).abs().max().item()
        bound = (2 * f1.numel() + b * h * w * 17) * 4 / 3.35e12 * 1e3
        for name in outs:
            key = f"{tag} {name}"
            print(f"[probe_band corr1d fp32] {key} {shape}: median "
                  f"{', '.join(f'{t['median']:.4f}' for t in times[key])} ms (mean "
                  f"{', '.join(f'{t['mean']:.4f}' for t in times[key])}), byte bound {bound:.4f} ms, "
                  f"max|d| vs kernel {diff[key]:.4g}", flush=True)
        del f1, f2, outs
    report = {"card": card, "nvcc": nvcc, "kernel": "corr1d_fp32_kernel", "shapes": shapes,
              "dtype": "float32", "ms": times, "max_abs_diff_vs_kernel": diff}
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
    ap.add_argument("--fp32", nargs="?", const="corr2d", choices=("corr2d", "corr1d"),
                    help="probe the fp32 kernels instead of the bf16 band kernels: corr2d's "
                         "(forward, or with --backward corr2d its backward; the default), or "
                         "corr1d's forward (at the training, eval-row and serving shapes, or "
                         "--shape)")
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
    if args.fp32 == "corr1d":
        if args.backward:
            ap.error("--fp32 corr1d probes corr1d's fp32 forward")
        names = args.variants.split(",") if args.variants else list(FWD1_32_VARIANTS)
        if sorted(set(names) - set(FWD1_32_VARIANTS)) or "kernel" not in names:
            ap.error(f"--variants: one of {sorted(FWD1_32_VARIANTS)}, with 'kernel'")
        shapes = {"shape": tuple(args.shape)} if tuple(args.shape) != SHAPE else FWD1_32_SHAPES
        report = probe_fwd1_fp32(card, nvcc, shapes, names)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    if args.fp32 and args.backward not in (None, "corr2d"):
        ap.error("--fp32 probes corr2d's kernels")
    if args.backward:
        report = probe_backward(card, nvcc, args.backward, args.fp32)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        return 0
    table = {n: (("corr2d",), e) for n, e in FWD32_VARIANTS.items()} if args.fp32 else VARIANTS
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    names = args.variants.split(",") if args.variants else list(table)
    unknown = sorted(set(names) - set(table))
    if unknown or "kernel" not in names:
        ap.error(f"--variants: unknown {unknown}, or no 'kernel' to hold the others against")
    libs = build_variants({n: table[n] for n in names})
    shape = tuple(args.shape)
    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    f2 = torch.randn(shape, device="cuda", generator=g).to(dtype)
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
            out = outs.setdefault((name, k), torch.zeros((b, h, w, ph * pw), dtype=dtype,
                                                         device="cuda"))

            def call():
                err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, ph, pw,
                         int(not args.fp32), 1, stream)
                if err != 0:
                    raise RuntimeError(f"{name} {k}: cudaError {err}")

            times.setdefault(f"{k} {name}", []).append(time_ms(call))
    # how far each variant's output lies from the kernel's (NaN where a
    # variant leaves garbage in shared memory)
    diff = {f"{k} {name}": (out.float() - outs[("kernel", k)].float()).abs().max().item()
            for (name, k), out in outs.items()}
    hmma = {f"{k} {name}": sass(path).count("HMMA") for (name, k), (_, path) in libs.items()}
    report = {"card": card, "nvcc": nvcc, "shape": list(shape), "dtype": str(dtype)[6:], "ms": times,
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
