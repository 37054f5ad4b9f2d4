// 17x17 patch correlation (stereo cost volume) for Hopper (sm_90a).
//
// Replaces the TPU kernel pmt_learning_for_semantic_segmentation_and_disparity_tpu/
// ops/correlation.py:_corr2d_kernel (correlation2d_pallas):
//
//   out[b,y,x,i*17+j] = sum_c f1[b,y,x,c] * f2[b,y+i-8,x+j-8,c],  i, j in [0,17),
//
// zero where (y+i-8, x+j-8) falls outside [0,H) x [0,W). NHWC in,
// (B,H,W,289) out, sums in fp32, stored in the input dtype (fp32 or bf16).
// The division by C of the normalized variant stays outside.
//
// Bound. At the sdnet shape f1 = f2 = (16,64,120,352) in bf16 the kernel must
// read f1 and f2 once (2 x 86.5 MB) and write the output once (71.0 MB):
// ~244 MB at 3.35 TB/s = ~73 us on an H100 SXM. The arithmetic is
// 2*16*64*120*289*352 = 25.0 GFLOP: 25 us at the 989 TFLOP/s bf16 tensor-core
// peak, so the bound is the bytes.
//
// bf16: the band tile of corr_band.cuh, on the tensor cores. One block owns
// kRows = 2 output rows y, y+1 and 64 columns, and walks the 18 f2 rows
// y-8 .. y+9 (those inside the image): each f2 window is staged once and
// serves both rows, and f1's two row tiles stay resident in shared memory.
// Grid (column tiles, H/2, B): 1024 blocks of 8 consumer warps and one
// producer warp at the sdnet shape, one per SM. What bounds it there, and
// what the design does:
// - re-staging f2 from L2: every f2 window is read once per pair of output
//   rows, 0.82 GB at the sdnet shape (a block of one row would read 1.56 GB,
//   and measures slower, PERF.md); the copy engine moves a whole f2 row's
//   window (6 boxes, 60 KB at C = 352) per stage of a 2-stage ring, which
//   overlaps the products of the stage before;
// - hand-offs: each stage costs the consumers a wait and the producer a
//   wait, and narrower stages (more of them per f2 row) measure slower
//   (PERF.md): stages as wide as shared memory allows, one per f2 row;
// - tensor-core products: 32/17 of the useful products, 47 GFLOP, fed by
//   ldmatrix from the swizzled boxes, one f2 fragment for both rows;
// - device memory: f1 and f2 are read about once (the f2 rows a wave of
//   blocks reaches, ~1.4 MB per image, stay in the 50 MB L2), the output
//   once, each warp storing its bands straight from the accumulators.
// Shared memory at C = 352: f1 2 x 6 boxes x 8 KB = 96 KB, f2 ring
// 2 x 6 boxes x 10 KB = 120 KB. A C too large for f1 to stay resident stages
// f1's boxes beside f2's in every stage instead.
//
// fp32 (corr2d_fp32_kernel): products and sums in fp32 FMAs on the CUDA cores,
// as the Pallas kernel multiplies and sums in fp32 (TF32 tensor cores would
// not hold fp32's tolerance). Bound: the 25.0 GFLOP of the sdnet shape are
// 12.5 G FMAs, 0.373 ms at the 67 TFLOP/s fp32 peak; its bytes (488 MB in
// fp32) take 0.146 ms, so the products bound it. At the training shape
// (8,32,64,352): 3.33 GFLOP, 0.050 ms.
// Design. One block owns kR = 4 output rows y0 .. y0+3 and 64 columns and
// walks the channels in stages of 16; f1's 4 rows and the f2 rows they reach
// (y0-8 .. y0+11) come into shared memory once per row group, 8.25 staged
// channel vectors an output pixel (the one-row design before it staged 38).
// The f2 rows are taken in 2 passes of 10 (a stage holds f1's 4 rows and 10
// f2 rows: 70 KB), each pass a block of its own (they write disjoint
// shifts), and within a pass every f2 row is worked at once, so the
// sum over all C stays in registers and no thread reduces with another:
// half-warp h of the 8 warps owns one (f2 row, row pair) unit that reaches
// both rows of the pair, 16 a pass, and a lane holds 2 output rows x 4
// adjacent columns x 17 shifts (136 fp32 accumulators). Per 4 channels it
// reads f1's 8 values and f2's 20 window columns as 16-byte loads (28 loads
// for 544 FMAs; 0.82 bytes of shared memory an FMA against the SM's 1), each
// f2 value feeding both rows. The 4 (row, f2 row) pairs a row pair reaches
// with one row only (f2 rows y0-8, y0+9 for pair 0, y0-6, y0+11 for pair 1)
// are shared out among that pair's half-warps, 2 or 3 shifts each, from the
// f1 values they hold already. A unit whose f2 row lies outside the image
// skips its products and stores zeros. At the end of a pass each pair's
// outputs go through the ring and out as whole runs of a pixel's shifts
// (coalesced stores; 4-byte stores 1,156 bytes apart cost 0.17 ms more at
// the serving shape).
// Where f1 lives: f1's 4 rows at C = 352 are 360 KB in fp32, so f1 is
// staged beside f2 in each stage rather than kept resident (the bf16 band
// keeps its two rows resident in 96 KB), and copied twice, once a pass.
// Grid (column tiles, 2 x row groups, B): 1,024 blocks at the serving shape.
// Copies: every thread issues 16-byte cp.async copies of its share of the
// next stage (zero-filled outside the image and past C), 4 threads a
// pixel's 64 bytes, a ring of 2 stages with one barrier a stage (3 stages
// measured slower). A tensor map's box cannot take the layout the lanes
// need: a lane's 4 columns put 8 lanes of a 16-byte load 4 columns apart,
// and only a pad of 16 bytes every 4 columns of 16 channels (chunk(col) = 4
// col + col / 4) puts them on 8 distinct bank groups; nor is a producer warp
// needed. 8 warps, not 9: 3 warps on one scheduler cap a thread at 168
// registers, and the 136 accumulators then spilled. Inputs cp.async cannot
// take (C % 4 != 0, or f1, f2 off 16-byte alignment) stage the same layout
// by element loads.
// What holds it (tools/probe_band.py --fp32, PERF.md §6): the copies,
// barriers and stores alone take 0.41 of its 1.01 ms at the serving shape
// (64-byte runs at ~3.7 TB/s) and overlap the products only in part; the
// edge shares cost 0.13 ms; the products run at ~40% of the FFMA peak.
//
// Backward (corr2d_backward). Replaces the lax VJP of the JAX package's
// _corr2d (ops/correlation.py:_corr2d_bwd_lax), which the TPU ran as XLA code
// beside the Pallas forward. With g = dL/dout and o = i - 8, p = j - 8:
//
//   df1[b,y,x,c]   = sum_{i,j} g[b,y,x,17i+j]         * f2[b,y+o,x+p,c],
//   df2[b,y',x',c] = sum_{i,j} g[b,y'-o,x'-p,17i+j]   * f1[b,y'-o,x'-p,c],
//
// zero terms outside the image. Mirrored (i -> 16-i, j -> 16-j), df2 takes
// df1's form: df2[y',x',c] = sum_{i,j} G2[y',x',i,j] * f1[y'+o,x'+p,c] with
// G2[y',x',i,j] = g[y'+o, x'+p, 288-17i-j]. So one kernel computes both, as
// out[y,x,c] = sum_{i,j} G[y,x,i,j] * F[y+o,x+p,c] with (G, F) = (g, f2) for
// df1 and (G2, f1) for df2.
//
// Bound: it must read f1, f2 and g and write df1 and df2 once; at the training
// shape per view, f1 = f2 = (8,32,64,352) and g = (8,32,64,289) in bf16, that
// is 55.6 MB, 16.6 us at 3.35 TB/s. The useful products, 2 x 2 x
// 8*32*64*289*352 = 6.67 GFLOP, take 6.7 us on the bf16 tensor cores but
// 0.0995 ms as fp32 FMAs on the CUDA cores: only the tensor cores can reach
// the byte bound.
//
// bf16, two launches. (1) The relayout (corr2d_bwd_relayout_kernel), one
// block per (b, y, 64-column tile): g's row y with an 8-column halo each side
// comes into shared memory (one 1-D bulk copy where g is 16-byte aligned and
// W % 8 == 0, else element loads), and the block writes, into the workspace
// the wrapper allocates, G's and G2's slices: for each (tensor, b, y, i,
// tile) the 17 values j of the tile's 64 pixels back to back (2176 bytes, a
// 1-D bulk copy's unit). At the training shape it reads g once (9.5 MB) and
// writes 16.4 MB. (2) The band (corr2d_bwd_band_kernel), persistent: one
// block per SM walks work items (tensor, b, 4 output rows y0 .. y0+3, 128
// channels, 64-column tile). An item walks F's rows r = y0-8 .. y0+11 inside
// the image, one stage each: F's 80-column window of row r in two 64-channel
// boxes (TMA, 128-byte swizzle; zero outside the image and past C) and, for
// each output row y' = y0 + a that row r reaches (i = r - y' + 8 in [0, 17)),
// the slice (y', i) of G (a 1-D bulk copy). A producer warp issues the
// copies; 8 consumer warps each take the 16-column slab w % 4 and the 64
// channels of box w / 4 for all 4 rows: per stage, B fragments from the box
// with ldmatrix.x4.trans (once for the 4 rows) and each row's banded A
// fragment from its slice, six 32-bit loads, two of them masked to the band
// 0 <= k - r <= 16 (mma.sync.m16n8k16, fp32 sums in registers: 128 a
// thread). The ring of kStages stages runs on across items (corr_band.cuh's
// mbarrier protocol), so the next item's copies overlap this item's last
// products and its stores, which go straight from the registers, a pixel's
// 64 channels in 8 consecutive stores. Every output element has one owner:
// no atomics, deterministic.
//
// What bounds it, and what the design does about it (PERF.md §6 has the
// readings of tools/probe_band.py --backward corr2d):
// - the copies into shared memory, which run near 3.3 TB/s: each F window is
//   copied once for every row group that reaches it, (4 + 16) / 4 = 5 times
//   (17 in the one-row design before it), 0.10 GB of in-image columns at the
//   training shape, and each slice once per 128-channel group (3 at C =
//   352), 0.05 GB; items of 2 or 3 rows measured slower;
// - the products: 32/17 of the useful products on mma.sync, 12.5 GFLOP at
//   the training shape. wgmma would take M = 64 output columns against all
//   80 window columns, 80/17 = 4.7x the useful products, so mma.sync stays
//   (corr_band.cuh says the same of the forward). The copies alone and the
//   products alone each take about 80% of the band's time;
// - registers: 9 warps put 3 on one scheduler and cap a thread at 168
//   registers, so the producer is a warpgroup that gives its registers up
//   (setmaxnreg); a warp-0 producer between its own products, which spares
//   them, serialised copies and products; an epilogue through shared memory
//   and TMA stores spilled;
// - hand-offs: 20 stages per 4 output rows and 128 channels, 6,528 at the
//   training shape (~23,000 of 64 channels and one row before);
// - device memory: the relayout's 16.4 MB written and read back from L2 is
//   the price of slices a copy engine can take whatever g's alignment and W.
// Inputs a tensor map cannot take (vec = 0: C % 8 != 0, or f1, f2, df1, df2
// off 16-byte alignment) take the same kernel with the producer staging the
// windows by element loads (the slices are the workspace's, always aligned)
// and element stores out.
//
// fp32 (corr2d_bwd_fp32_kernel): the same two launches, in fp32. Replaces,
// like the bf16 pair, the lax VJP _corr2d_bwd_lax. Bound: the 6.67 GFLOP of
// the training shape as fp32 FMAs take 0.0995 ms at 67 TFLOP/s, its 111 MB
// 0.033 ms: the products bound it (serving shape 0.746 ms, 834 MB).
// The relayout is the bf16 one for 4-byte values, with each pixel's 17
// values padded to 20 (a slice 5,120 bytes), so that the band reads G four
// shifts at a time in 16-byte loads. The band is persistent, one block an
// SM, walking the same items (4 output rows x 128 channels x 64 columns, df1
// and df2 as df1 of the mirror): a stage is F's 80-column window of one row
// (128 channels, 40 KB, 512-byte runs a pixel) and the slices of the item's
// rows it serves, 3 stages in a ring of 16-byte cp.async copies that every
// thread issues, run on across items so that the next item's copies overlap
// this item's last products and stores. 8 warps, warp m the 8-column slab
// 8m .. 8m+7; a lane owns 2 adjacent columns x 16 channels (4 quads, the 8
// lanes of a column reading 8 consecutive 16-byte chunks: no bank conflict)
// for all 4 rows (128 accumulators). Per window column it reads F's 4 quads
// once for the rows F's row serves, and each G value (one address for the 8
// lanes of a column) feeds 16 FMAs: 112 loads for 2,176 FMAs a stage that
// serves the 4 rows (14 of an interior item's 20), one unrolled body for
// those and one a row for the rest. Every output element has one owner: no
// atomics, deterministic.
// What holds it (tools/probe_band.py --backward corr2d --fp32, PERF.md §6):
// the products. The copies alone take a third of the band's time and overlap
// with them; the relayout is 0.03 ms of the 0.3. Tried and slower: a loop
// over the window columns with a branch a row (1.5x: the branches keep the
// loads from being hoisted), 8 channels a lane on 16 warps (4%), 2 stages
// (equal).
#include "corr_band.cuh"

namespace {

constexpr int kPH = 17;                  // vertical shifts
constexpr int kPatch = kPH * band::kPW;  // 289 outputs per pixel
constexpr int kRows = 2;                 // output rows per bf16 block
constexpr int kBoxes = 6;                // 64-channel boxes per stage of the bf16 ring

// 16-byte copies from global to shared memory by cp.async (the fp32 kernels'
// ring): zero-filled, and nothing read, where !in (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(band::smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 channels c .. c+3 of one pixel (row points at its channel 0), zero past C.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int C) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float* e = &v.x;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c + k < C) e[k] = row[c + k];
  return v;
}

namespace fwd32 {

constexpr int kPW = band::kPW;
constexpr int kHalo = kPW / 2;             // 8
constexpr int kTX = band::kTX;             // output columns per block
constexpr int kWin = band::kWin;           // f2 columns a block reads (80)
constexpr int kR = 4;                      // output rows per block (2 pairs)
constexpr int kPasses = 2;                 // passes over the f2 rows y0-8 .. y0+11
constexpr int kF2 = 10;                    // f2 rows per pass
constexpr int kCS = 16;                    // channels per stage (4 quads)
constexpr int kThreads = 32 * 8;           // 16 half-warps, one full unit each
// a staged row: quad q (channels 4q .. 4q+3 of the stage) of column col at
// 16-byte chunk chunk(col) + q; the pad every 4 columns puts the 8 lanes of
// a 16-byte load (4 columns apart) on 8 distinct bank groups
__host__ __device__ constexpr int chunk(int col) { return 4 * col + col / 4; }
constexpr int kF1Row = chunk(kTX);         // 272 chunks
constexpr int kF2Row = chunk(kWin);        // 340 chunks
constexpr int kStage = kR * kF1Row + kF2 * kF2Row;  // 4,488 chunks (71,808 bytes)
constexpr int kStages = 2;
constexpr size_t kSmem = (size_t)kStages * kStage * 16;
static_assert(kSmem <= band::kSmemMax, "the ring fits a block");
static_assert(kPasses * kF2 == kR + 2 * kHalo, "the passes cover the f2 rows");


// The full unit of half-warp hw in pass p: row pair `pair` (rows y0 + 2 pair,
// + 1) against the pass's f2 row k (image row y0 - 8 + 10p + k), both rows
// within reach. Pass 0 takes pair 0's f2 rows y0-7 .. y0+1 and pair 1's
// y0-5 .. y0+1, pass 1 pair 0's y0+2 .. y0+8 and pair 1's y0+2 .. y0+10.
__host__ __device__ constexpr int unit_pair(int p, int hw) { return hw >= (p == 0 ? 9 : 7); }
__host__ __device__ constexpr int unit_row(int p, int hw) {
  return p == 0 ? (hw < 9 ? hw + 1 : hw - 6) : (hw < 7 ? hw : hw - 7);
}
// The edge units a pair reaches with one row only (f2 row y0-8 or y0+9 for
// pair 0, y0-6 or y0+11 for pair 1), one a pair and pass: pair e's edge in
// pass p is its row p (row 2e + p of the block) against the pass's f2 row
// k = 2e (p = 0) or 7 + 2e (p = 1), shift i = 0 or 16. The pair's own
// half-warps share it, each its shifts edge_shift(n, u) .. edge_shift(n,
// u + 1) - 1 of all 64 columns (u: the half-warp's place among the pair's n
// = 7 or 9), from the f1 values of that row it holds already.
__host__ __device__ constexpr int edge_f2(int p, int e) { return p == 0 ? 2 * e : 7 + 2 * e; }
__host__ __device__ constexpr int edge_shift(int n, int u) { return (kPW * u + n - 1) / n; }
constexpr int kEdgeShifts = 3;  // at most a half-warp's: 17 over 7

// One 16-byte quad, channels c .. c+3 of pixel (row, x) of image img of a
// (B, H, W, C) tensor, into dst: a cp.async copy (kVec), else element loads;
// zero where !in.
template <bool kVec>
__device__ __forceinline__ void copy_quad(float4* dst, const float* __restrict__ base, size_t img,
                                          int row, int x, int c, bool in, int W, int C) {
  const float* src = base + (in ? ((img + row) * W + x) * C + c : 0);
  if (kVec)
    cp_async16(dst, src, in);
  else
    *dst = in ? load4(src - c, c, C) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// A lane's share of its pair's edge for one quad: shifts j0 .. j0 + 2 of its
// 4 columns (those past its share are never stored), f1's values u (the
// edge's row), f2's window columns 4l + j0 + t from se (the edge's f2 row at
// the lane's column 4l), the last column repeated past the window.
__device__ __forceinline__ void edge_products(float (&acce)[4][kEdgeShifts], const float4 (&u)[4],
                                              const float4* __restrict__ se, int j0) {
#pragma unroll
  for (int t = 0; t < 3 + kEdgeShifts; ++t) {
    const int wc = min(j0 + t, kWin - 1 - 4 * (int)(threadIdx.x & 15));
    const float4 v2 = se[4 * wc + wc / 4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int jj = t - x;
      if (jj < 0 || jj >= kEdgeShifts) continue;
      float a = acce[x][jj];
      a = fmaf(u[x].x, v2.x, a);
      a = fmaf(u[x].y, v2.y, a);
      a = fmaf(u[x].z, v2.z, a);
      acce[x][jj] = fmaf(u[x].w, v2.w, a);
    }
  }
}

// This thread's copies of one stage into st: channels c0 .. c0+15 of f1's 4
// rows (64 columns from x0) and of the 10 f2 rows from rbase (80 columns
// from x0 - 8), zero outside the image and past C. Thread t copies quad
// t % 4 of the staged columns t / 4 + 64n: 4 threads a pixel's 64 bytes.
template <bool kVec>
__device__ __forceinline__ void stage_copies(float4* __restrict__ st, const float* __restrict__ f1,
                                             const float* __restrict__ f2, size_t img, int y0,
                                             int x0, int rbase, int c0, int H, int W, int C) {
  const int q = threadIdx.x & 3, m0 = threadIdx.x >> 2;
  const int c = c0 + 4 * q;
  const bool cin = c < C;
#pragma unroll
  for (int a = 0; a < kR; ++a)  // f1's rows: column m0
    copy_quad<kVec>(st + a * kF1Row + chunk(m0) + q, f1, img, y0 + a, x0 + m0, c,
                    cin && y0 + a < H && x0 + m0 < W, W, C);
  int k = 0, col = m0;  // f2's staged column m0 + 64n: row k, column col
#pragma unroll
  for (int n = 0; n < (kF2 * kWin + 63) / 64; ++n) {
    if (k < kF2) {
      const int row = rbase + k, x = x0 - kHalo + col;
      copy_quad<kVec>(st + kR * kF1Row + k * kF2Row + chunk(col) + q, f2, img, row, x, c,
                      cin && row >= 0 && row < H && x >= 0 && x < W, W, C);
    }
    col += 64;
    if (col >= kWin) col -= kWin, ++k;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
corr2d_fp32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) float4 ring32[];
  // block (tile, 2 * row group + pass, b): the passes write disjoint shifts,
  // so each is a block of its own (twice the blocks: 128 at the training
  // shape, where one block a row group left half of the 132 SMs idle)
  const int x0 = blockIdx.x * kTX, y0 = (blockIdx.y >> 1) * kR, p = blockIdx.y & 1;
  const size_t img = (size_t)blockIdx.z * H;
  const int nst = (C + kCS - 1) / kCS;       // stages a pass
  const int hw = threadIdx.x >> 4, l = threadIdx.x & 15;  // lane l: columns 4l .. 4l+3
  float acc[2][4][kPW], acce[4][kEdgeShifts];

  {
    const int rbase = y0 - kHalo + kF2 * p;  // the image row of the pass's f2 row 0
    const int pair = unit_pair(p, hw), k = unit_row(p, hw);
    const int r = rbase + k;                 // this unit's f2 row
    // this half-warp's share of its pair's edge: shifts j0 .. j0 + ns - 1
    const int first = pair == 0 ? 0 : (p == 0 ? 9 : 7), npair = pair == (p == 0 ? 0 : 1) ? 9 : 7;
    const int j0 = edge_shift(npair, hw - first), ns = edge_shift(npair, hw - first + 1) - j0;
    const int ke = edge_f2(p, pair), re = rbase + ke;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int j = 0; j < kPW; ++j) acc[a][x][j] = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int jj = 0; jj < kEdgeShifts; ++jj) acce[x][jj] = 0.f;

    // stage s of the pass: channels 16s .. 16s+15; one cp.async group a
    // stage, empty or not
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst)
        stage_copies<kVec>(ring32 + (size_t)s * kStage, f1, f2, img, y0, x0, rbase, s * kCS, H, W, C);
      cp_async_commit();
    }
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<kStages - 2>();  // this thread's copies of stage s are in
      __syncthreads();               // ... every thread's; stage s - 1 is read
      const int sn = s + kStages - 1;  // into stage s - 1's buffer
      if (sn < nst)
        stage_copies<kVec>(ring32 + (size_t)(sn % kStages) * kStage, f1, f2, img, y0, x0, rbase,
                           sn * kCS, H, W, C);
      cp_async_commit();
      const float4* st = ring32 + (size_t)(s % kStages) * kStage;
      // one body without a branch: rows outside the image are staged as
      // zeros, so a unit or an edge there sums zeros (a branch around
      // each kept the loads from being hoisted)
#pragma unroll 1
      for (int q = 0; q < kCS / 4; ++q) {
        const float4* s1 = st + 2 * pair * kF1Row + 17 * l + q;  // chunk(4l) = 17l
        float4 v1[2][4];  // the pair's f1 values, channels 4q .. 4q+3 of the stage
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int x = 0; x < 4; ++x) v1[a][x] = s1[a * kF1Row + 4 * x];
        {
          const float4* s2 = st + kR * kF1Row + k * kF2Row + 17 * l + q;
#pragma unroll
          for (int w = 0; w < 4 + kPW - 1; ++w) {  // f2 window column 4l + w
            const float4 v2 = s2[4 * w + w / 4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int j = w - x;  // the shift of column 4l + x that meets it
              if (j < 0 || j >= kPW) continue;
#pragma unroll
              for (int a = 0; a < 2; ++a) {
                float t = acc[a][x][j];
                t = fmaf(v1[a][x].x, v2.x, t);
                t = fmaf(v1[a][x].y, v2.y, t);
                t = fmaf(v1[a][x].z, v2.z, t);
                acc[a][x][j] = fmaf(v1[a][x].w, v2.w, t);
              }
            }
          }
        }
        {
          // the edge's shifts j0 + jj of the pair's row p: window columns
          // 4l + j0 + t against the f1 values of v1[p]
          float4 u[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) u[x] = p == 0 ? v1[0][x] : v1[1][x];
          edge_products(acce, u, st + kR * kF1Row + ke * kF2Row + 17 * l + q, j0);
        }
      }
    }
    // The pass's outputs: row y0 + a holds shifts ilo(a) .. ihi(a) of this
    // pass, one run of 17 (ihi - ilo + 1) values a pixel in the output. Each
    // pair's rows go through the ring (free now) and out in whole runs, a
    // warp a pixel: coalesced stores in place of 4-byte ones 1,156 bytes
    // apart. Units whose f2 row lies outside the image hold zeros.
    __syncthreads();  // every warp is done with the ring
    float* stage = reinterpret_cast<float*>(ring32);
#pragma unroll 1
    for (int pr = 0; pr < 2; ++pr) {
      int ilo[2], len[2], base[2];  // rows 2pr, 2pr + 1: first shift, run length, staging offset
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int y = y0 + 2 * pr + a;
        ilo[a] = max(0, rbase + kHalo - y);
        len[a] = kPW * (min(kPH - 1, rbase + kF2 - 1 + kHalo - y) - ilo[a] + 1);
        base[a] = a == 0 ? 0 : kTX * len[0];
      }
      if (pair == pr) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int y = y0 + 2 * pr + a, i = r - y + kHalo;
          if (i < 0 || i >= kPH) continue;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float* o = stage + base[a] + (4 * l + x) * len[a] + kPW * (i - ilo[a]);
#pragma unroll
            for (int j = 0; j < kPW; ++j) o[j] = acc[a][x][j];
          }
        }
      }
      if (pair == pr) {  // the pair's edge is its row p, shift i = 0 or 16
        const int i = re - (y0 + 2 * pr + p) + kHalo;
        const int eb = p == 0 ? base[0] : base[1], el = p == 0 ? len[0] : len[1];
        const int ei = p == 0 ? ilo[0] : ilo[1];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float* o = stage + eb + (4 * l + x) * el + kPW * (i - ei) + j0;
#pragma unroll
          for (int jj = 0; jj < kEdgeShifts; ++jj)
            if (jj < ns) o[jj] = acce[x][jj];
        }
      }
      __syncthreads();
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int y = y0 + 2 * pr + a;
        if (y >= H) continue;
        for (int col = warp; col < kTX && x0 + col < W; col += kThreads / 32) {
          const float* src = stage + base[a] + col * len[a];
          float* o = out + ((img + y) * W + x0 + col) * kPatch + kPW * ilo[a];
          for (int n = lane; n < len[a]; n += 32) o[n] = src[n];
        }
      }
      __syncthreads();  // the staging is read before the next pair's
    }
  }
}

int launch(const float* f1, const float* f2, float* out, int B, int H, int W, int C, bool vec,
           cudaStream_t stream) {
  auto kernel = vec ? corr2d_fp32_kernel<true> : corr2d_fp32_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTX - 1) / kTX, kPasses * ((H + kR - 1) / kR), B);
  kernel<<<grid, kThreads, kSmem, stream>>>(f1, f2, out, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace fwd32

template <bool kTma>
__global__ void __launch_bounds__(band::kThreads, 1)
corr2d_band_kernel(const __grid_constant__ CUtensorMap tm1, const __grid_constant__ CUtensorMap tm2,
                   const band::bf16* __restrict__ f1, const band::bf16* __restrict__ f2,
                   band::bf16* __restrict__ out, int H, int W, int C, int ns, int kb, int f1_res) {
  extern __shared__ unsigned char smem[];
  const size_t img = (size_t)blockIdx.z * H * W;
  band::band_tile<kRows, kTma>(&tm1, &tm2, f1 + img * C, f2 + img * C, out + img * kPatch,
                               blockIdx.z, blockIdx.y * kRows, blockIdx.x * band::kTX, H, W, C,
                               kPH, ns, kb, f1_res != 0, smem);
}

int launch_bf16(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
                cudaStream_t stream) {
  const band::Plan p = band::plan(C, kRows, kBoxes, band::kSmemMax);
  // vec (C a multiple of 8, 16-byte aligned inputs) is what a tensor map takes
  CUtensorMap tm1{}, tm2{};
  if (vec) {
    cudaError_t err = band::tensor_map(&tm1, f1, B, H, W, C, band::kTX);
    if (err == cudaSuccess) err = band::tensor_map(&tm2, f2, B, H, W, C, band::kWin);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = vec ? corr2d_band_kernel<true> : corr2d_band_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + band::kTX - 1) / band::kTX, (H + kRows - 1) / kRows, B);
  kernel<<<grid, band::kThreads, p.smem, stream>>>(
      tm1, tm2, static_cast<const band::bf16*>(f1), static_cast<const band::bf16*>(f2),
      static_cast<band::bf16*>(out), H, W, C, p.ns, p.kb, (int)p.f1_res);
  return (int)cudaGetLastError();
}

namespace bwd {

using band::bf16;
constexpr int kPW = band::kPW;
constexpr int kHalo = kPW / 2;            // 8
constexpr int kTX = band::kTX;            // output columns per item
constexpr int kCC = band::kCC;            // channels per box
constexpr int kR = 4;                     // output rows per item
constexpr int kBoxes = 2;                 // 64-channel boxes per stage
constexpr int kCG = kBoxes * kCC;         // channels per item
constexpr int kWinBox = band::kF2Box;     // one window box: 80 columns x 64 channels (10 KB)
// a G slice: the 17 values j of the tile's 64 pixels back to back, pixel
// q's value j at gpos(q, j). (A pad of 8 values every 4 pixels would put the
// 8 pixel rows of an A load on 8 distinct bank groups, where none leaves
// two-way conflicts; it measured no faster than the 10% fewer bytes.)
constexpr int kSlice = kTX * kPW;  // 1088 values (2176 bytes): the bf16 slice
constexpr int kSliceBytes = kSlice * 2;
static_assert(kSliceBytes % 16 == 0, "a slice is a bulk copy");
__host__ __device__ constexpr int gpos(int q, int j) { return kPW * q + j; }
// fp32 slices pad a pixel's 17 values to 20, so that the band takes them 4 at
// a time in 16-byte loads: pixel q's value j at 20q + j (5,120 bytes a slice)
template <typename T>
constexpr int kPixT = sizeof(T) == 4 ? 20 : kPW;
template <typename T>
constexpr int kSliceT = kTX * kPixT<T>;
// slice words between A rows r and r + 8: (gpos(q + 8, j - 8) - gpos(q, j)) / 2
constexpr int kRow8 = (8 * kPW - 8) / 2;  // 64
// a stage: kBoxes window boxes, then one slice per output row; kept on the
// swizzle's 1024 bytes
constexpr int kStage = (kBoxes * kWinBox + kR * kSliceBytes + 1023) / 1024 * 1024;
constexpr int kStages = 7;                // ring stages
// [kStages stages][barriers], with 1 KB of slack to align the boxes to the
// swizzle's 1024 bytes
constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + 2 * kStages * 8;
static_assert(kSmem <= band::kSmemMax, "the ring fits a block");
// the relayout: g's row tile with its halo (80 pixels x 289 values) and one
// tensor's 17 slices, in the element type T
constexpr int kRelThreads = 256;
template <typename T>
constexpr size_t rel_smem() {
  return ((size_t)band::kWin * kPatch + (size_t)kPH * kSliceT<T>) * sizeof(T) + 16;
}

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ bf16 zero_value<bf16>() { return __float2bfloat16(0.f); }
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }

// values of the workspace: G and G2 slices, [tensor][b][y][i][tile][kSliceT<T>]
template <typename T>
inline size_t work_values(int B, int H, int W) {
  return (size_t)2 * B * H * kPH * ((W + kTX - 1) / kTX) * kSliceT<T>;
}

// The relayout: block (tile, y, b) writes, from g's row y, G's slices (b, y,
// i, tile) whose F row y + i - 8 lies in the image and G2's slices (b, y + 8
// - i, i, tile) whose row lies in the image (their F row is y):
//   G [y,  x, i, j] = g[y, x, 17i + j],
//   G2[y2, x, i, j] = g[y, x + j - 8, 288 - 17i - j],  y2 = y + 8 - i,
// zero for x >= W and where x + j - 8 falls outside [0, W). Each tensor's
// 17 slices are assembled in shared memory, then stored with 16-byte stores.
// T: bf16 or fp32, g's and the workspace's element type (fp32 slices in the
// padded layout of kPixT, the pads left as they are: never read as values).
template <typename T>
__global__ void __launch_bounds__(kRelThreads)
corr2d_bwd_relayout_kernel(const T* __restrict__ g, T* __restrict__ work, int B, int H, int W,
                           int fast) {
  extern __shared__ __align__(16) unsigned char smem_rel[];
  T* tile = reinterpret_cast<T*>(smem_rel);  // pixel x0 - 8 + q at q * 289
  T* stage = tile + band::kWin * kPatch;     // one tensor's 17 slices
  constexpr int kS = kSliceT<T>, kP = kPixT<T>;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kPH * kS);
  const int tx = blockIdx.x, ntx = gridDim.x, y = blockIdx.y, b = blockIdx.z;
  const int x0 = tx * kTX;
  const int xs = max(0, x0 - kHalo), xe = min(W, x0 + kTX + kHalo);
  const T* src = g + (((size_t)b * H + y) * W + xs) * kPatch;
  T* dst = tile + (xs - (x0 - kHalo)) * kPatch;
  const int n = (xe - xs) * kPatch;
  if (fast) {  // g 16-byte aligned and W % 8 == 0: xs, xe are multiples of 8
    if (threadIdx.x == 0) {
      band::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      band::mbar_expect_tx(bar, n * sizeof(T));
      band::bulk_load(dst, src, n * sizeof(T), bar);
    }
    __syncthreads();
    band::mbar_wait(bar, 0);
  } else {  // element loads, 8 in flight a thread
    for (int k0 = threadIdx.x; k0 < n; k0 += 8 * kRelThreads) {
      T v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e * kRelThreads;
        v[e] = k < n ? src[k] : zero_value<T>();
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k0 + e * kRelThreads < n) dst[k0 + e * kRelThreads] = v[e];
    }
    __syncthreads();
  }
  const size_t row_stride = (size_t)kPH * ntx * kS;  // values of one (tensor, b, y)
  const T zero = zero_value<T>();
  constexpr int kVec = 16 / sizeof(T);                   // values a 16-byte store
  for (int t = 0; t < 2; ++t) {
    // the 17 slices in shared memory, one (i, pixel) a thread at a time
    for (int k = threadIdx.x; k < kPH * kTX; k += kRelThreads) {
      const int i = k / kTX, q = k % kTX;
      const bool in = x0 + q < W;
      T* o = stage + i * kS + kP * q;
      if (t == 0) {
        const T* s = tile + (q + kHalo) * kPatch + kPW * i;
#pragma unroll
        for (int j = 0; j < kPW; ++j) o[j] = in ? s[j] : zero;
      } else {
        // s[j * 288]: value 288 - 17i - j of pixel q + j
        const T* s = tile + q * kPatch + (kPatch - 1) - kPW * i;
#pragma unroll
        for (int j = 0; j < kPW; ++j) {
          const int xj = x0 + q + j - kHalo;
          o[j] = in && xj >= 0 && xj < W ? s[j * (kPatch - 1)] : zero;
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kPH * (kS / kVec); k += kRelThreads) {
      const int i = k / (kS / kVec), c8 = k % (kS / kVec);
      const int yy = t == 0 ? y : y + kHalo - i;  // the slice's output row
      const int fr = t == 0 ? y + i - kHalo : y;  // the F row it multiplies
      if (yy < 0 || yy >= H || fr < 0 || fr >= H) continue;  // never read
      T* out = work + (((size_t)t * B + b) * H + yy) * row_stride +
               ((size_t)i * ntx + tx) * kS + kVec * c8;
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(stage + i * kS + kVec * c8);
    }
    __syncthreads();
  }
}

// A work item: tensor t (0: df1 from (G, f2), 1: df2 from (G2, f1)), image
// b, output rows y0 .. y0+nr-1, channels c0 .. c0+127, columns x0 .. x0+63,
// F rows r_lo .. r_hi-1.
struct Item {
  int t, b, y0, nr, c0, tx, x0, r_lo, r_hi;
};

__device__ __forceinline__ Item item_at(int k, int B, int H, int C, int ntx) {
  const int ny = (H + kR - 1) / kR, ncg = (C + kCG - 1) / kCG;
  Item it;
  it.tx = k % ntx, k /= ntx;
  const int yg = k % ny;
  k /= ny;
  it.c0 = (k % ncg) * kCG, k /= ncg;
  it.b = k % B, it.t = k / B;
  it.y0 = yg * kR, it.x0 = it.tx * kTX;
  it.nr = min(kR, H - it.y0);
  it.r_lo = max(0, it.y0 - kHalo);
  it.r_hi = min(H, it.y0 + it.nr + kHalo);
  return it;
}

constexpr int kConsumers = 8;                    // 4 slabs x 2 boxes
constexpr int kThreads = 32 * (4 + kConsumers);  // + the producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers' (4 x 32 x 56 + 8 x 32 x 224 <= 65536)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// The band. Warpgroup 0 is the producer (its warp 0 issues the copies, and
// the warpgroup hands its registers to the consumers with setmaxnreg);
// warpgroups 1 and 2 are the 8 consumer warps.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
corr2d_bwd_band_kernel(const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ CUtensorMap tm2, const bf16* __restrict__ f1,
                       const bf16* __restrict__ f2, const bf16* __restrict__ work,
                       bf16* __restrict__ df1, bf16* __restrict__ df2, int B, int H, int W,
                       int C) {
  using namespace band;
  extern __shared__ unsigned char smem_bwd[];
  const int ntx = (W + kTX - 1) / kTX;
  const int items = 2 * B * ((C + kCG - 1) / kCG) * ((H + kR - 1) / kR) * ntx;
  const size_t row_stride = (size_t)kPH * ntx * kSlice;

  unsigned char* ring = smem_bwd + ((1024 - (smem_u32(smem_bwd) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)kStages * kStage);
  uint64_t* empty = full + kStages;

  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    // ---- producer: stage j = F row r of the block's items in turn: F's
    // window boxes of row r and the slices of the output rows it reaches ----
    int j = 0;
    for (int k = blockIdx.x; k < items; k += gridDim.x) {
      const Item it = item_at(k, B, H, C, ntx);
      const int nbox = min(kBoxes, (C - it.c0 + kCC - 1) / kCC);
      const bf16* gw = work + ((size_t)it.t * B + it.b) * H * row_stride + (size_t)it.tx * kSlice;
      for (int r = it.r_lo; r < it.r_hi; ++r, ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);  // released
        unsigned char* st = ring + (size_t)s * kStage;
        if (!kTma) {
          const bf16* frow = (it.t == 0 ? f2 : f1) + ((size_t)it.b * H + r) * W * C;
          for (int q = 0; q < nbox; ++q)
            copy_box(st + q * kWinBox, frow, it.x0 - kHalo, kWin, W, C, it.c0 + q * kCC, lane);
          __syncwarp();
        }
        if (lane == 0) {
          int rows = 0;  // output rows y0 + a that F's row r reaches
          for (int a = 0; a < it.nr; ++a) rows += abs(r - it.y0 - a) <= kHalo;
          mbar_expect_tx(&full[s], (kTma ? nbox * kWinBox : 0) + rows * kSliceBytes);
          if (kTma)
            for (int q = 0; q < nbox; ++q)
              tma_load(st + q * kWinBox, it.t == 0 ? &tm2 : &tm1, it.c0 + q * kCC,
                       it.x0 - kHalo, r, it.b, &full[s]);
          for (int a = 0; a < it.nr; ++a) {
            const int i = r - it.y0 - a + kHalo;
            if (i >= 0 && i < kPH)
              bulk_load(st + kBoxes * kWinBox + a * kSliceBytes,
                        gw + (size_t)(it.y0 + a) * row_stride + (size_t)i * ntx * kSlice,
                        kSliceBytes, &full[s]);
          }
        }
        __syncwarp();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- consumers ----
  const int warp = (threadIdx.x >> 5) - 4;
  const int m = warp & 3;   // slab: output columns 16m .. 16m+15 of the tile
  const int h = warp >> 2;  // box h of the stage: the item's channels 64h .. 64h+63
  const int gid = lane >> 2, tig = lane & 3;
  // B fragments: ldmatrix.trans rows window column 16m + 16ks + kr, channels
  // 16np + cb .. +7 (matrices: k 0-7 / 8-15 x channels 0-7 / 8-15), in the
  // box's swizzle; k-step ks adds 16 rows (2048 bytes)
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int cb = (lane >> 4) * 8;
  uint32_t boff[kCC / 16];
#pragma unroll
  for (int np = 0; np < kCC / 16; ++np) boff[np] = h * kWinBox + swz(16 * m + kr, 16 * np + cb);
  // A fragments of the slab's band A[r,k] = G[x0+16m+r, i, k-r] (zero unless
  // 0 <= k-r <= 16), register q of k-step ks holding rows r = gid + 8(q&1),
  // columns k = 16ks + 8(q>>1) + 2tig + {0, 1}: one 32-bit word of the
  // slice at word gpos(16m+r, k-r) / 2 = abase + kRow8(q&1) + 8ks + 4(q>>1).
  // With d = 2tig - gid in [-7, 6]: (ks, q) = (0, 1), (1, 2) lie outside the
  // band (zero), (0, 2), (1, 1) inside it, and (0, 0), (0, 3) keep the halves
  // with d >= 0 / d + 1 >= 0, (1, 0), (1, 3) those with d <= 0 / d <= -1.
  const int abase = gpos(16 * m + gid, 2 * tig - gid) / 2;
  const int d = 2 * tig - gid;
  const uint32_t m0 = (d >= 0 ? 0xffffu : 0u) | (d + 1 >= 0 ? 0xffff0000u : 0u);
  const uint32_t m16 = (d <= 0 ? 0xffffu : 0u) | (d <= -1 ? 0xffff0000u : 0u);
  float acc[kR][kCC / 8][4];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int n = 0; n < kCC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  int j = 0;  // stages consumed
  for (int k = blockIdx.x; k < items; k += gridDim.x) {
    const Item it = item_at(k, B, H, C, ntx);
    const int cw = it.c0 + kCC * h;  // this warp's first channel
    // the slab has a column and the box a channel inside the image (channels
    // of the box past C are zeros: the copies fill them)
    const bool live = it.x0 + 16 * m < W && cw < C;
    for (int r = it.r_lo; r < it.r_hi; ++r, ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      if (live) {
        const unsigned char* st = ring + (size_t)s * kStage;
        const uint32_t bx = smem_u32(st);
        const uint32_t* sa = reinterpret_cast<const uint32_t*>(st + kBoxes * kWinBox) + abase;
        bool on[kR];  // output row y0 + a is served by F's row r (uniform)
#pragma unroll
        for (int a = 0; a < kR; ++a) on[a] = a < it.nr && abs(r - it.y0 - a) <= kHalo;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bfrag[kCC / 16][4], afrag[kR][4];
#pragma unroll
          for (int np = 0; np < kCC / 16; ++np)
            ldmatrix_x4_trans(bfrag[np], bx + boff[np] + 2048 * ks);
#pragma unroll
          for (int a = 0; a < kR; ++a) {  // every row's slot: a row not served is not used
            const uint32_t* w = sa + a * (kSliceBytes / 4);
            if (ks == 0) {
              afrag[a][0] = w[0] & m0;
              afrag[a][1] = 0u;
              afrag[a][2] = w[4];
              afrag[a][3] = w[kRow8 + 4] & m0;
            } else {
              afrag[a][0] = w[8] & m16;
              afrag[a][1] = w[kRow8 + 8];
              afrag[a][2] = 0u;
              afrag[a][3] = w[kRow8 + 12] & m16;
            }
          }
#pragma unroll
          for (int a = 0; a < kR; ++a) {
            if (!on[a]) continue;
#pragma unroll
            for (int np = 0; np < kCC / 16; ++np) {
              mma_bf16(acc[a][2 * np], afrag[a], bfrag[np][0], bfrag[np][1]);
              mma_bf16(acc[a][2 * np + 1], afrag[a], bfrag[np][2], bfrag[np][3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s
    }
    if (!live) continue;  // nothing accumulated
    // the item is complete: accumulator (row, column) of n-tile n of row a is
    // output (y0 + a, x0 + 16m + row, cw + 8n + column); a pixel's 64
    // channels go out in 8 consecutive stores
    bf16* out = (it.t == 0 ? df1 : df2) + ((size_t)it.b * H + it.y0) * W * C;
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = it.x0 + 16 * m + gid + 8 * hh;
#pragma unroll
        for (int n = 0; n < kCC / 8; ++n) {
          const int c = cw + 8 * n + 2 * tig;
          if (a < it.nr && x < W && c < C) {
            bf16* o = out + ((size_t)a * W + x) * C + c;
            if (kTma) {  // C % 8 == 0 and 16-byte aligned outputs
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(acc[a][n][2 * hh], acc[a][n][2 * hh + 1]);
            } else {
              o[0] = __float2bfloat16(acc[a][n][2 * hh]);
              if (c + 1 < C) o[1] = __float2bfloat16(acc[a][n][2 * hh + 1]);
            }
          }
          acc[a][n][2 * hh] = acc[a][n][2 * hh + 1] = 0.f;
        }
      }
  }
}


// SMs of the current device
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// (1) of both dtypes: the relayout of g into G's and G2's slices
template <typename T>
int relayout(const void* g, void* work, int B, int H, int W, cudaStream_t stream) {
  if (work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bool fast = W % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      corr2d_bwd_relayout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rel_smem<T>());
  if (err != cudaSuccess) return (int)err;
  const int ntx = (W + kTX - 1) / kTX;
  corr2d_bwd_relayout_kernel<T><<<dim3(ntx, H, B), kRelThreads, rel_smem<T>(), stream>>>(
      static_cast<const T*>(g), static_cast<T*>(work), B, H, W, (int)fast);
  return (int)cudaGetLastError();
}

// (2) a persistent grid: one block an SM, or one an item
inline int band_grid(int B, int H, int W, int C) {
  const long long items =
      2LL * B * ((C + kCG - 1) / kCG) * ((H + kR - 1) / kR) * ((W + kTX - 1) / kTX);
  const int sms = sm_count();
  if (items > 0x7fffffffLL || sms <= 0) return -1;
  return items < sms ? (int)items : sms;
}

int launch_bf16(const void* f1, const void* f2, const void* g, void* df1, void* df2, void* work,
                int B, int H, int W, int C, bool vec, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)relayout<bf16>(g, work, B, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  // (2) the band: vec (C a multiple of 8, 16-byte aligned f1, f2, df1, df2)
  // is what a tensor map and the paired stores take
  CUtensorMap tm1{}, tm2{};
  if (vec) {
    err = band::tensor_map(&tm1, f1, B, H, W, C, band::kWin);
    if (err == cudaSuccess) err = band::tensor_map(&tm2, f2, B, H, W, C, band::kWin);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = vec ? corr2d_bwd_band_kernel<true> : corr2d_bwd_band_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = band_grid(B, H, W, C);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm1, tm2, static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
      static_cast<const bf16*>(work), static_cast<bf16*>(df1), static_cast<bf16*>(df2), B, H, W, C);
  return (int)cudaGetLastError();
}

// ---- fp32: the band on the CUDA cores ----
constexpr int kThreads32 = 256;                 // 8 warps, one 8-column slab each
constexpr int kWinChunks = band::kWin * kCG / 4;  // F's window: 80 columns x 128 channels (40 KB)
constexpr int kSlice32 = kSliceT<float>;          // an fp32 slice: 1,280 values
constexpr int kSliceChunks = kSlice32 / 4;        // 320 chunks of 16 bytes
constexpr int kStage32 = kWinChunks + kR * kSliceChunks;  // 3,840 chunks (61,440 bytes)
constexpr int kStages32 = 3;
constexpr size_t kSmem32 = (size_t)kStages32 * kStage32 * 16;
static_assert(kSmem32 <= band::kSmemMax, "the fp32 ring fits a block");

// A stage of the block's walk: item k (Item) and its F row r.
struct Cursor {
  int k, r;
  Item it;
};

__device__ __forceinline__ void cursor_at(Cursor& c, int k, int items, int B, int H, int C,
                                          int ntx) {
  c.k = k;
  if (k < items) {
    c.it = item_at(k, B, H, C, ntx);
    c.r = c.it.r_lo;
  }
}

__device__ __forceinline__ void cursor_next(Cursor& c, int items, int B, int H, int C, int ntx) {
  if (++c.r == c.it.r_hi) cursor_at(c, c.k + gridDim.x, items, B, H, C, ntx);
}

// One F row's products for the rows of `on`: lane (xg, cg) of warp m owns
// columns xl = 8m + 2xg, xl + 1 and the 16 channels 4cg + 32t + {0..3}, t <
// 4. fw: the window's column xl, quad cq = cg; gs: the stage's slices, row a's at
// gs + a * kSlice32, from the lane's pixel xl; G's values come 4 shifts at a
// time (a 16-byte load at every fourth shift). kAll (every row served, 14 of an
// interior item's 20 F rows): one unrolled body without a branch, F's 4 quads
// read once a window column for the 4 rows; else a body a row it serves.
// (A loop over the window columns with a branch a row measured 1.5x slower:
// the branches keep the G loads from being hoisted.)
template <bool kAll>
__device__ __forceinline__ void products32(float (&acc)[kR][2][16], const float4* __restrict__ fw,
                                           const float* __restrict__ gs, const bool (&on)[kR]) {
#pragma unroll
  for (int a0 = 0; a0 < (kAll ? 1 : kR); ++a0) {
    if (!kAll && !on[a0]) continue;
    float4 gq[kR][2];  // G's values of shifts 4(j / 4) .. +3 of row a, column xl + x
#pragma unroll
    for (int w = 0; w < 2 + kPW - 1; ++w) {  // window column xl + w
      float4 f[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) f[t] = fw[w * (kCG / 4) + 8 * t];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = w - x;  // the shift of column xl + x that meets it
        if (j < 0 || j >= kPW) continue;
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          if (!kAll && a != a0) continue;
          if (j % 4 == 0)
            gq[a][x] = *reinterpret_cast<const float4*>(gs + a * kSlice32 + kPixT<float> * x + j);
          const float gv = j % 4 == 0 ? gq[a][x].x : j % 4 == 1 ? gq[a][x].y
                         : j % 4 == 2 ? gq[a][x].z : gq[a][x].w;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[a][x][4 * t] = fmaf(gv, f[t].x, acc[a][x][4 * t]);
            acc[a][x][4 * t + 1] = fmaf(gv, f[t].y, acc[a][x][4 * t + 1]);
            acc[a][x][4 * t + 2] = fmaf(gv, f[t].z, acc[a][x][4 * t + 2]);
            acc[a][x][4 * t + 3] = fmaf(gv, f[t].w, acc[a][x][4 * t + 3]);
          }
        }
      }
    }
  }
}

// This thread's copies of the stage (item it, F row r) into st: F's window
// (80 columns x 128 channels from (x0 - 8, c0)) and the slices of the rows r
// serves.
template <bool kVec>
__device__ __forceinline__ void stage_copies32(float4* __restrict__ st, const Item& it, int r,
                                               const float* __restrict__ f1,
                                               const float* __restrict__ f2,
                                               const float* __restrict__ work, int B, int H, int W,
                                               int C, int ntx, size_t row_stride) {
  const float* frow = (it.t == 0 ? f2 : f1) + ((size_t)it.b * H + r) * W * C;
  for (int n = threadIdx.x; n < kWinChunks; n += kThreads32) {
    const int col = n / (kCG / 4), c = it.c0 + 4 * (n % (kCG / 4));
    const int x = it.x0 - kHalo + col;
    const bool in = x >= 0 && x < W && c < C;
    const float* src = frow + (in ? (size_t)x * C + c : 0);
    if (kVec)
      cp_async16(st + n, src, in);
    else
      st[n] = in ? load4(src - c, c, C) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* gw = work + ((size_t)it.t * B + it.b) * H * row_stride + (size_t)it.tx * kSlice32;
  for (int a = 0; a < it.nr; ++a) {
    const int i = r - it.y0 - a + kHalo;
    if (i < 0 || i >= kPH) continue;
    const float4* src = reinterpret_cast<const float4*>(
        gw + (size_t)(it.y0 + a) * row_stride + (size_t)i * ntx * kSlice32);
    for (int n = threadIdx.x; n < kSliceChunks; n += kThreads32)
      cp_async16(st + kWinChunks + a * kSliceChunks + n, src + n, true);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads32, 1)
corr2d_bwd_fp32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       const float* __restrict__ work, float* __restrict__ df1,
                       float* __restrict__ df2, int B, int H, int W, int C) {
  extern __shared__ __align__(16) float4 ring_b32[];
  const int ntx = (W + kTX - 1) / kTX;
  const int items = 2 * B * ((C + kCG - 1) / kCG) * ((H + kR - 1) / kR) * ntx;
  const size_t row_stride = (size_t)kPH * ntx * kSlice32;
  const int lane = threadIdx.x & 31;
  const int cq = lane & 7;                                  // channel quads cq + 8t
  const int xl = 8 * (threadIdx.x >> 5) + 2 * (lane >> 3);  // columns xl, xl + 1 of the tile

  // the loading cursor runs kStages32 - 1 stages ahead; its stage j goes
  // into buffer j % kStages32, one cp.async group a stage, empty or not
  Cursor ld;
  cursor_at(ld, blockIdx.x, items, B, H, C, ntx);
  int jl = 0;

  float acc[kR][2][16];
#pragma unroll
  for (int a = 0; a < kR; ++a)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[a][x][e] = 0.f;

  for (int s = 0; s < kStages32 - 1; ++s, ++jl) {
    if (ld.k < items) {
      stage_copies32<kVec>(ring_b32 + (size_t)jl * kStage32, ld.it, ld.r, f1, f2, work, B, H, W, C,
                           ntx, row_stride);
      cursor_next(ld, items, B, H, C, ntx);
    }
    cp_async_commit();
  }
  Cursor cp;
  cursor_at(cp, blockIdx.x, items, B, H, C, ntx);
  for (int jc = 0; cp.k < items; ++jc) {
    cp_async_wait<kStages32 - 2>();  // this thread's copies of stage jc are in
    __syncthreads();                 // ... every thread's; stage jc - 1 is read
    if (ld.k < items) {              // stage jl = jc + 2 into stage jc - 1's buffer
      stage_copies32<kVec>(ring_b32 + (size_t)(jl % kStages32) * kStage32, ld.it, ld.r, f1, f2,
                           work, B, H, W, C, ntx, row_stride);
      cursor_next(ld, items, B, H, C, ntx);
    }
    cp_async_commit();
    ++jl;
    const Item& it = cp.it;
    const bool live = it.x0 + xl < W;  // a column of the lane lies in the image
    if (live) {
      const float4* st = ring_b32 + (size_t)(jc % kStages32) * kStage32;
      const float4* fw = st + xl * (kCG / 4) + cq;
      const float* gs = reinterpret_cast<const float*>(st + kWinChunks) + kPixT<float> * xl;
      bool on[kR];  // output row y0 + a is served by F's row r (uniform)
      bool all_on = true;
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        on[a] = a < it.nr && abs(cp.r - it.y0 - a) <= kHalo;
        all_on = all_on && on[a];
      }
      if (all_on)
        products32<true>(acc, fw, gs, on);
      else
        products32<false>(acc, fw, gs, on);
    }
    if (cp.r == it.r_hi - 1) {
      // the item is complete: a pixel's 16 channels of the lane in 4
      // 16-byte stores, 8 lanes a column storing 128 consecutive bytes
      float* out = (it.t == 0 ? df1 : df2) + ((size_t)it.b * H + it.y0) * W * C;
#pragma unroll
      for (int a = 0; a < kR; ++a)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = it.x0 + xl + x;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int c = it.c0 + 4 * cq + 32 * t;
            if (a < it.nr && col < W && c < C) {
              float* o = out + ((size_t)a * W + col) * C + c;
              if (kVec) {
                *reinterpret_cast<float4*>(o) = make_float4(acc[a][x][4 * t], acc[a][x][4 * t + 1],
                                                            acc[a][x][4 * t + 2], acc[a][x][4 * t + 3]);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  if (c + e < C) o[e] = acc[a][x][4 * t + e];
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][x][4 * t + e] = 0.f;
          }
        }
    }
    cursor_next(cp, items, B, H, C, ntx);
  }
}

int launch_fp32(const void* f1, const void* f2, const void* g, void* df1, void* df2, void* work,
                int B, int H, int W, int C, bool vec, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)relayout<float>(g, work, B, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  // (2) the band: vec (C a multiple of 4, 16-byte aligned f1, f2, df1, df2)
  // is what the 16-byte copies and stores take
  auto kernel = vec ? corr2d_bwd_fp32_kernel<true> : corr2d_bwd_fp32_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem32);
  if (err != cudaSuccess) return (int)err;
  const int grid = band_grid(B, H, W, C);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads32, kSmem32, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<const float*>(work),
      static_cast<float*>(df1), static_cast<float*>(df2), B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

extern "C" {

// f1, f2: contiguous (B,H,W,C); out: contiguous (B,H,W,ph*pw) with
// (ph, pw) = (17, 17); same dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// vec: 16-byte loads (C a multiple of 16 / sizeof(dtype), pointers 16-byte
// aligned). Launches on `stream` without synchronising; returns the launch's
// CUDA error code (0 on success).
int corr2d_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int ph,
                   int pw, int is_bf16, int vec, void* stream) {
  if (ph != kPH || pw != band::kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(f1, f2, out, B, H, W, C, vec != 0, s)
                 : fwd32::launch(static_cast<const float*>(f1), static_cast<const float*>(f2),
                                 static_cast<float*>(out), B, H, W, C, vec != 0, s);
}

// The plan the bf16 band's launch takes for C channels, as corr1d_forward_plan.
void corr2d_forward_plan(int C, int* out) {
  const band::Plan p = band::plan(C, kRows, kBoxes, band::kSmemMax);
  out[0] = p.ns, out[1] = p.kb, out[2] = (int)p.f1_res, out[3] = (int)p.smem;
}

// The gradients of corr2d_forward (no normalize): f1, f2, df1, df2 contiguous
// (B,H,W,C), one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); g, the
// output gradient, contiguous (B,H,W,289) of the same dtype; any alignment of
// the element type. work: corr2d_backward_workspace(...) bytes, 16-byte
// aligned, for g's relayout in the same dtype. vec: C a multiple of 16 /
// sizeof(dtype) and f1, f2, df1, df2 16-byte aligned (bf16: tensor-map copies
// in and paired stores out; fp32: 16-byte cp.async copies in and 16-byte
// stores out); with vec = 0 the same kernels stage and store element by
// element.
// Writes every element of df1 and df2. Launches on `stream` without
// synchronising; returns the launch's CUDA error code (0 on success).
int corr2d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2,
                    void* work, int B, int H, int W, int C, int is_bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535 ||
      ((long long)W + band::kTX - 1) / band::kTX * ((C + band::kCC - 1) / band::kCC) >
          0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd::launch_bf16(f1, f2, g, df1, df2, work, B, H, W, C, vec != 0, s)
                 : bwd::launch_fp32(f1, f2, g, df1, df2, work, B, H, W, C, vec != 0, s);
}

// The bytes of corr2d_backward's workspace at this shape and dtype: G's and
// G2's slices, 2 or 4 bytes a value.
size_t corr2d_backward_workspace(int B, int H, int W, int C, int is_bf16) {
  (void)C;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  return is_bf16 ? bwd::work_values<bwd::bf16>(B, H, W) * 2 : bwd::work_values<float>(B, H, W) * 4;
}

}  // extern "C"
