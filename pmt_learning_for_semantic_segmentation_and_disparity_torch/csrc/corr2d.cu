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
// fp32: corr_tile.cuh's row tile on the CUDA cores (TF32 tensor cores would
// not hold fp32's tolerance). The 17 vertical shifts are split across blocks:
// grid (column tiles x 17, H, B), block (t*17 + i, y, b) runs the row tile of
// f1's row y against f2's row y+i-8 and writes outputs [i*17, i*17+17) of each
// of its pixels; a block whose f2 row lies outside [0,H) writes zeros. Its
// floor is the 25.0 GFLOP as FMAs at 67 TFLOP/s, ~0.37 ms.
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
// fp32: corr_tile.cuh's backward tile with kPH = 17, on the CUDA cores.
#include "corr_band.cuh"
#include "corr_tile.cuh"

namespace {

constexpr int kPH = 17;                  // vertical shifts
constexpr int kPatch = kPH * corr::kPW;  // 289 outputs per pixel
constexpr int kRows = 2;                 // output rows per bf16 block
constexpr int kBoxes = 6;                // 64-channel boxes per stage of the bf16 ring

template <typename T, bool kVec>
__global__ void __launch_bounds__(corr::kThreads, 4)
corr2d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int H, int W, int C) {
  using namespace corr;
  __shared__ __align__(16) float s1[kTX * kS];
  __shared__ __align__(16) float s2[kF2Rows * kS];
  const int i = blockIdx.x % kPH;
  const int x0 = (blockIdx.x / kPH) * kTX;
  const int y = blockIdx.y;
  const int y2 = y + i - kPH / 2;
  const size_t row = (size_t)blockIdx.z * H + y;
  T* o = out + row * W * kPatch + i * kPW;
  if (y2 < 0 || y2 >= H) {  // uniform over the block: no thread reaches a barrier
    zero_tile(o, kPatch, x0, W);
    return;
  }
  const size_t row2 = (size_t)blockIdx.z * H + y2;
  row_tile<T, kVec>(f1 + row * W * C, f2 + row2 * W * C, o, kPatch, x0, W, C, s1, s2);
}

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

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
           cudaStream_t stream) {
  const dim3 grid(((W + corr::kTX - 1) / corr::kTX) * kPH, H, B);
  auto kernel = vec ? corr2d_kernel<T, true> : corr2d_kernel<T, false>;
  kernel<<<grid, corr::kThreads, 0, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                              static_cast<T*>(out), H, W, C);
  return (int)cudaGetLastError();
}

template <>
int launch<band::bf16>(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                       bool vec, cudaStream_t stream) {
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
constexpr int kSlice = kTX * kPW;  // 1088 values (2176 bytes)
constexpr int kSliceBytes = kSlice * 2;
static_assert(kSliceBytes % 16 == 0, "a slice is a bulk copy");
__host__ __device__ constexpr int gpos(int q, int j) { return kPW * q + j; }
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
// tensor's 17 slices
constexpr int kRelThreads = 256;
constexpr size_t kRelSmem = (size_t)band::kWin * kPatch * 2 + (size_t)kPH * kSliceBytes + 16;

// values of the workspace: G and G2 slices, [tensor][b][y][i][tile][kSlice]
inline size_t work_values(int B, int H, int W) {
  return (size_t)2 * B * H * kPH * ((W + kTX - 1) / kTX) * kSlice;
}

// The relayout: block (tile, y, b) writes, from g's row y, G's slices (b, y,
// i, tile) whose F row y + i - 8 lies in the image and G2's slices (b, y + 8
// - i, i, tile) whose row lies in the image (their F row is y):
//   G [y,  x, i, j] = g[y, x, 17i + j],
//   G2[y2, x, i, j] = g[y, x + j - 8, 288 - 17i - j],  y2 = y + 8 - i,
// zero for x >= W and where x + j - 8 falls outside [0, W). Each tensor's
// 17 slices are assembled in shared memory, then stored with 16-byte stores.
__global__ void __launch_bounds__(kRelThreads)
corr2d_bwd_relayout_kernel(const bf16* __restrict__ g, bf16* __restrict__ work, int B, int H,
                           int W, int fast) {
  extern __shared__ __align__(16) unsigned char smem_rel[];
  bf16* tile = reinterpret_cast<bf16*>(smem_rel);  // pixel x0 - 8 + q at q * 289
  bf16* stage = tile + band::kWin * kPatch;        // one tensor's 17 slices
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kPH * kSlice);
  const int tx = blockIdx.x, ntx = gridDim.x, y = blockIdx.y, b = blockIdx.z;
  const int x0 = tx * kTX;
  const int xs = max(0, x0 - kHalo), xe = min(W, x0 + kTX + kHalo);
  const bf16* src = g + (((size_t)b * H + y) * W + xs) * kPatch;
  bf16* dst = tile + (xs - (x0 - kHalo)) * kPatch;
  const int n = (xe - xs) * kPatch;
  if (fast) {  // g 16-byte aligned and W % 8 == 0: xs, xe are multiples of 8
    if (threadIdx.x == 0) {
      band::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      band::mbar_expect_tx(bar, n * 2);
      band::bulk_load(dst, src, n * 2, bar);
    }
    __syncthreads();
    band::mbar_wait(bar, 0);
  } else {  // element loads, 8 in flight a thread
    for (int k0 = threadIdx.x; k0 < n; k0 += 8 * kRelThreads) {
      bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e * kRelThreads;
        v[e] = k < n ? src[k] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k0 + e * kRelThreads < n) dst[k0 + e * kRelThreads] = v[e];
    }
    __syncthreads();
  }
  const size_t row_stride = (size_t)kPH * ntx * kSlice;  // values of one (tensor, b, y)
  const bf16 zero = __float2bfloat16(0.f);
  for (int t = 0; t < 2; ++t) {
    // the 17 slices in shared memory, one (i, pixel) a thread at a time
    for (int k = threadIdx.x; k < kPH * kTX; k += kRelThreads) {
      const int i = k / kTX, q = k % kTX;
      const bool in = x0 + q < W;
      bf16* o = stage + i * kSlice + gpos(q, 0);
      if (t == 0) {
        const bf16* s = tile + (q + kHalo) * kPatch + kPW * i;
#pragma unroll
        for (int j = 0; j < kPW; ++j) o[j] = in ? s[j] : zero;
      } else {
        // s[j * 288]: value 288 - 17i - j of pixel q + j
        const bf16* s = tile + q * kPatch + (kPatch - 1) - kPW * i;
#pragma unroll
        for (int j = 0; j < kPW; ++j) {
          const int xj = x0 + q + j - kHalo;
          o[j] = in && xj >= 0 && xj < W ? s[j * (kPatch - 1)] : zero;
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kPH * (kSlice / 8); k += kRelThreads) {
      const int i = k / (kSlice / 8), c8 = k % (kSlice / 8);
      const int yy = t == 0 ? y : y + kHalo - i;  // the slice's output row
      const int fr = t == 0 ? y + i - kHalo : y;  // the F row it multiplies
      if (yy < 0 || yy >= H || fr < 0 || fr >= H) continue;  // never read
      bf16* out = work + (((size_t)t * B + b) * H + yy) * row_stride +
                  ((size_t)i * ntx + tx) * kSlice + 8 * c8;
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(stage + i * kSlice + 8 * c8);
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

int launch_bf16(const void* f1, const void* f2, const void* g, void* df1, void* df2, void* work,
                int B, int H, int W, int C, bool vec, cudaStream_t stream) {
  if (work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // (1) the relayout of g into G's and G2's slices
  const bool fast = W % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(corr2d_bwd_relayout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRelSmem);
  if (err != cudaSuccess) return (int)err;
  const int ntx = (W + kTX - 1) / kTX;
  corr2d_bwd_relayout_kernel<<<dim3(ntx, H, B), kRelThreads, kRelSmem, stream>>>(
      static_cast<const bf16*>(g), static_cast<bf16*>(work), B, H, W, (int)fast);
  err = cudaGetLastError();
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
  const long long items =
      2LL * B * ((C + kCG - 1) / kCG) * ((H + kR - 1) / kR) * ntx;
  const int sms = sm_count();
  if (items > 0x7fffffffLL || sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tm1, tm2, static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
      static_cast<const bf16*>(work), static_cast<bf16*>(df1), static_cast<bf16*>(df2), B, H, W, C);
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
  if (ph != kPH || pw != corr::kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 ||
      B > 65535 || ((long long)W + corr::kTX - 1) / corr::kTX * kPH > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<band::bf16>(f1, f2, out, B, H, W, C, vec != 0, s)
                 : launch<float>(f1, f2, out, B, H, W, C, vec != 0, s);
}

// The plan the bf16 band's launch takes for C channels, as corr1d_forward_plan.
void corr2d_forward_plan(int C, int* out) {
  const band::Plan p = band::plan(C, kRows, kBoxes, band::kSmemMax);
  out[0] = p.ns, out[1] = p.kb, out[2] = (int)p.f1_res, out[3] = (int)p.smem;
}

// The gradients of corr2d_forward (no normalize): f1, f2, df1, df2 contiguous
// (B,H,W,C), one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); g, the
// output gradient, contiguous (B,H,W,289) of the same dtype; any alignment of
// the element type. work: bf16, corr2d_backward_workspace(...) bytes,
// 16-byte aligned, for g's relayout (fp32 takes none: nullptr). vec: C a
// multiple of 16 / sizeof(dtype) and f1, f2, df1, df2 16-byte aligned (bf16:
// tensor-map copies in and paired stores out; fp32: 16-byte loads and
// stores); with vec = 0 the same kernels stage and store element by element.
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
                 : corr::launch_bwd_fp32<kPH>(f1, f2, g, df1, df2, B, H, W, C, vec != 0, s);
}

// The bytes of corr2d_backward's workspace at this shape and dtype.
size_t corr2d_backward_workspace(int B, int H, int W, int C, int is_bf16) {
  (void)C;
  return is_bf16 && B > 0 && H > 0 && W > 0 ? bwd::work_values(B, H, W) * 2 : 0;
}

}  // extern "C"
