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
// beside the Pallas forward. With g = dL/dout and o = i - 8:
//
//   df1[b,y,x,c]   = sum_{i,j} g[b,y,x,17i+j]             * f2[b,y+o,x+j-8,c],
//   df2[b,y',x',c] = sum_{i,j} g[b,y'-o,x'-j+8,17i+j]     * f1[b,y'-o,x'-j+8,c],
//
// zero terms outside the image. For one row offset i both sums are corr1d's
// backward (corr1d.cu) with g[..., 17i : 17i+17] as its g: df1's row y
// gathers f2's row y+o, df2's row y' gathers f1's and g's row y'-o. So the
// kernel runs corr1d's transposed band once per row offset and sums the 17
// bands in registers. Each output element is one sum, owned by one thread:
// no atomics, deterministic.
//
// Bound: it must read f1, f2 and g and write df1 and df2 once; at the training
// shape per view, f1 = f2 = (8,32,64,352) and g = (8,32,64,289) in bf16, that
// is 55.6 MB, 16.6 us at 3.35 TB/s. The useful products, 2 x 2 x
// 8*32*64*289*352 = 6.67 GFLOP, take 6.7 us on the bf16 tensor cores but
// 0.0995 ms as fp32 FMAs on the CUDA cores: only the tensor cores can reach
// the byte bound.
//
// bf16: one block per (b, y, 64-column tile, 64-channel box), 8 consumer
// warps and 1 producer warp. Warp w owns the 16-column slab w % 4 of df1
// (w < 4) or of df2 (w >= 4) for the block's 64 channels and keeps its 16 x 64
// sums (32 fp32 registers a thread) across the row offsets; the slab is
// final after the last offset and leaves by a TMA store of 16 columns x 64
// channels. The producer walks the row offsets whose rows lie in the image
// through a 3-stage ring (corr_band.cuh's mbarrier protocol), four tiled TMA
// copies a stage: f1's 80 x 64 window box of row y-o and f2's of row y+o (in
// the 128-byte swizzle; a row outside the image is not copied, and the warps
// that would read it skip their products), and g's values 17i .. 17i+23 of
// the 80 window columns of row y (df1's A) and of row y-o (df2's A). g's own
// pixel stride, 289 x 2 = 578 bytes, is no tensor-map stride, so the wrapper
// pads g to 296 values a pixel (592 bytes) first. The A fragments are built
// from those boxes in registers, the band mask applied, and B fragments come
// from the window boxes with ldmatrix.x4.trans, as in corr1d's backward.
// (g read straight into the A fragments by element loads, each warp load
// touching 8 pixels 578 bytes apart, took half the time of a first design,
// and staging it by the producer's element loads twice the time: PERF.md
// §6.) What it costs: each f1 and f2 window is copied from L2 once per output
// row that reaches it, 17 times (0.49 GB from L2 at the training shape), the
// price of keeping the sums of one output row per block in registers.
// Inputs a tensor map cannot take (vec = 0: C % 8 != 0, or a pointer off
// 16-byte alignment) take the same kernel with the producer staging the
// windows by element loads and the consumers storing by element stores.
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
constexpr int kCC = band::kCC;            // channels per box (and per block)
constexpr int kSlab = 16;                 // output columns per consumer warp
constexpr int kWinBox = band::kF2Box;     // one window box: 80 columns x 64 channels (10 KB)
constexpr int kGP = 296;                  // g's values a pixel as the kernel takes it: 289 + 7 unread
// g values a g box takes at each row offset: 32 from 17i rounded down to a
// multiple of 8 (a 16-byte aligned start), which hold the offset's 17
constexpr int kGC = 32;
constexpr int kGBox = band::kWin * kGC * 2;  // one g box: 80 columns x 32 values (5 KB)
// a stage: F1w box, F2w box, df1's g box (row y), df2's g box (row y-o); 30
// KB, which keeps the next stage's boxes on the swizzle's 1024 bytes
constexpr int kStage = 2 * kWinBox + 2 * kGBox;
static_assert(kStage % 1024 == 0, "a stage keeps the swizzle's alignment");
constexpr int kOutBox = kSlab * kCC * 2;  // one warp's output box: 16 columns x 64 channels (2 KB)
constexpr int kStages = 3;                // ring stages
// [kStages stages][one output box per consumer warp][barriers], with 1 KB of
// slack to align the boxes to the swizzle's 1024 bytes: ~107 KB, two blocks
// an SM
constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + band::kConsumers * kOutBox +
                         2 * kStages * 8;

// The producer warp's element copy of one g box: columns [xb, xb + 80) x
// values [v0, v0 + 32) of one row of the (B, H, W, 296) g, zero outside
// [0, W) x [0, 296), in the layout the copy engine writes (32 values a column).
__device__ __forceinline__ void copy_gbox(bf16* dst, const bf16* __restrict__ row, int xb, int W,
                                          int v0, int lane) {
  for (int k = lane; k < band::kWin * kGC; k += 32) {
    const int x = xb + k / kGC, v = v0 + k % kGC;
    dst[k] = x >= 0 && x < W && v < kGP ? row[(size_t)x * kGP + v] : __float2bfloat16(0.f);
  }
}

template <bool kTma>
__global__ void __launch_bounds__(band::kThreads, 2)
corr2d_bwd_band_kernel(const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ CUtensorMap tm2,
                       const __grid_constant__ CUtensorMap tmg,
                       const __grid_constant__ CUtensorMap td1,
                       const __grid_constant__ CUtensorMap td2, const bf16* __restrict__ f1,
                       const bf16* __restrict__ f2, const bf16* __restrict__ g,
                       bf16* __restrict__ df1, bf16* __restrict__ df2, int H, int W, int C) {
  using namespace band;
  extern __shared__ unsigned char smem_bwd[];
  const int nb = (C + kCC - 1) / kCC;
  const int c0 = (blockIdx.x % nb) * kCC;
  const int x0 = (blockIdx.x / nb) * kTX;
  const int y = blockIdx.y, b = blockIdx.z;
  const size_t img = (size_t)b * H;
  // row offsets: df1 reads f2's row y + i - 8 and df2 f1's and g's row
  // y - i + 8; those of either inside [0, H) form one range (both hold i = 8)
  const int i_lo = max(0, min(kHalo - y, y + kHalo + 1 - H));
  const int i_hi = min(kPH, max(H + kHalo - y, y + kHalo + 1));
  const int items = i_hi - i_lo;

  unsigned char* ring = smem_bwd + ((1024 - (smem_u32(smem_bwd) & 1023)) & 1023);
  unsigned char* obox = ring + (size_t)kStages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(obox + kConsumers * kOutBox);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: stage j = row offset i = i_lo + j: F1w (row y-o), F2w
    // (row y+o), and g's 32 values from 8 * floor(17i / 8) of rows y and y-o ----
    for (int j = 0; j < items; ++j) {
      const int s = j % kStages;
      const int u = j / kStages;
      if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);  // the consumers have released it
      const int i = i_lo + j;
      const int r1 = y - i + kHalo, r2 = y + i - kHalo;
      const bool in1 = r1 >= 0 && r1 < H, in2 = r2 >= 0 && r2 < H;
      unsigned char* st = ring + (size_t)s * kStage;
      bf16* g1 = reinterpret_cast<bf16*>(st + 2 * kWinBox);
      bf16* g2 = g1 + kWin * kGC;
      if (kTma) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], in1 * (kWinBox + kGBox) + in2 * kWinBox + kGBox);
          if (in1) tma_load(st, &tm1, c0, x0 - kHalo, r1, b, &full[s]);
          if (in2) tma_load(st + kWinBox, &tm2, c0, x0 - kHalo, r2, b, &full[s]);
          tma_load(g1, &tmg, i * kPW & ~7, x0 - kHalo, y, b, &full[s]);
          if (in1) tma_load(g2, &tmg, i * kPW & ~7, x0 - kHalo, r1, b, &full[s]);
        }
      } else {
        if (in1) copy_box(st, f1 + (img + r1) * W * C, x0 - kHalo, kWin, W, C, c0, lane);
        if (in2) copy_box(st + kWinBox, f2 + (img + r2) * W * C, x0 - kHalo, kWin, W, C, c0, lane);
        copy_gbox(g1, g + (img + y) * W * kGP, x0 - kHalo, W, i * kPW & ~7, lane);
        if (in1) copy_gbox(g2, g + (img + r1) * W * kGP, x0 - kHalo, W, i * kPW & ~7, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers ----
  const int m = warp & 3;       // slab: output columns 16m .. 16m+15 of the tile
  const int t = warp >> 2;      // 0: df1 (B from F2w), 1: df2 (B from F1w)
  const int gid = lane >> 2, tig = lane & 3;
  const bool live = x0 + 16 * m < W;  // the slab has columns inside the image
  // ldmatrix.trans rows of this lane: window column 16m + 16ks + kr, channels
  // 16np + cb .. +7 (matrices: k 0-7 / 8-15 x channels 0-7 / 8-15)
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int cb = (lane >> 4) * 8;
  float acc[kCC / 8][4];
#pragma unroll
  for (int n = 0; n < kCC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < items; ++j) {
    const int s = j % kStages;
    const int i = i_lo + j;
    const int row = t == 0 ? y + i - kHalo : y - i + kHalo;  // the row of this warp's B
    mbar_wait(&full[s], (j / kStages) & 1);
    if (live && row >= 0 && row < H) {
      // A fragments of the slab's two k-steps (k = 16m + kk, kk in [0, 32)),
      // register q holding row gid + 8(q&1), columns 8(q>>1) + 2 tig + {0, 1},
      // from the stage's g boxes (window column w is image column x0 - 8 + w,
      // box value v is g's 8 * floor(17i / 8) + v, so offset i's value d sits
      // at v = i % 8 + d; zero outside [0, W)):
      //   df1: A1[r,k] = g[y,   x0 + r,     17i + k - r]
      //   df2: A2[r,k] = g[y-o, x0 - 8 + k, 17i + 16 - (k - r)]
      // both zero unless 0 <= k - r <= 16
      const unsigned char* st = ring + (size_t)s * kStage;
      const bf16* ga = reinterpret_cast<const bf16*>(st + 2 * kWinBox) + t * kWin * kGC +
                       16 * m * kGC + (i & 7);
      uint32_t afrag[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = gid + 8 * (q & 1);  // slab-local output column
          bf16 v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = 16 * ks + 8 * (q >> 1) + 2 * tig + e;
            const int dd = kk - r;
            v[e] = __float2bfloat16(0.f);
            if (dd >= 0 && dd < kPW)
              v[e] = t == 0 ? ga[(r + kHalo) * kGC + dd] : ga[kk * kGC + kPW - 1 - dd];
          }
          const __nv_bfloat162 p = __halves2bfloat162(v[0], v[1]);
          afrag[ks][q] = *reinterpret_cast<const uint32_t*>(&p);
        }
      const uint32_t bx = smem_u32(st + (t == 0 ? kWinBox : 0));
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int np = 0; np < kCC / 16; ++np) {
          uint32_t bfrag[4];
          ldmatrix_x4_trans(bfrag, bx + swz(16 * m + 16 * ks + kr, 16 * np + cb));
          mma_bf16(acc[2 * np], afrag[ks], bfrag[0], bfrag[1]);
          mma_bf16(acc[2 * np + 1], afrag[ks], bfrag[2], bfrag[3]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s
  }
  if (!live) return;  // the whole slab lies past the image

  // the slab is complete: accumulator (row, column) of n-tile n is output
  // column x0 + 16m + row, channel c0 + 8n + column
  if (kTma) {
    unsigned char* ob = obox + warp * kOutBox;
#pragma unroll
    for (int n = 0; n < kCC / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(ob + swz(gid + 8 * h, 8 * n + 2 * tig)) =
            __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      tma_store(t == 0 ? &td1 : &td2, ob, c0, x0 + 16 * m, y, b);
      bulk_commit();
      bulk_wait<0>();  // the store is done before the block ends
    }
  } else {
    bf16* out = (t == 0 ? df1 : df2) + (img + y) * W * C;
#pragma unroll
    for (int n = 0; n < kCC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = x0 + 16 * m + gid + 8 * (e >> 1);
        const int c = c0 + 8 * n + 2 * tig + (e & 1);
        if (x < W && c < C) out[(size_t)x * C + c] = __float2bfloat16(acc[n][e]);
      }
  }
}

int launch_bf16(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B, int H,
                int W, int C, bool vec, cudaStream_t stream) {
  // vec (C a multiple of 8, 16-byte aligned tensors) is what a tensor map
  // takes; g, with 296 values a pixel (592 bytes), takes one whenever it is
  // 16-byte aligned, which the wrapper's allocation is
  CUtensorMap tm1{}, tm2{}, tmg{}, td1{}, td2{};
  if (vec) {
    cudaError_t err = band::tensor_map(&tm1, f1, B, H, W, C, band::kWin);
    if (err == cudaSuccess) err = band::tensor_map(&tm2, f2, B, H, W, C, band::kWin);
    if (err == cudaSuccess)
      err = band::tensor_map(&tmg, g, B, H, W, kGP, band::kWin, kGC, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) err = band::tensor_map(&td1, df1, B, H, W, C, kSlab);
    if (err == cudaSuccess) err = band::tensor_map(&td2, df2, B, H, W, C, kSlab);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = vec ? corr2d_bwd_band_kernel<true> : corr2d_bwd_band_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + band::kTX - 1) / band::kTX) * ((C + kCC - 1) / kCC), H, B);
  kernel<<<grid, band::kThreads, kSmem, stream>>>(
      tm1, tm2, tmg, td1, td2, static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
      static_cast<const bf16*>(g), static_cast<bf16*>(df1), static_cast<bf16*>(df2), H, W, C);
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

// The gradients of corr2d_forward (no normalize): f1, f2, df1, df2 contiguous
// (B,H,W,C), one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); any
// alignment of the element type. g, the output gradient, contiguous: fp32
// (B,H,W,289); bf16 (B,H,W,296) and 16-byte aligned, its values 289 .. 295 a
// pixel never read (the padding gives it a tensor map's stride). vec: C a multiple of 16 /
// sizeof(dtype) and f1, f2, df1, df2 16-byte aligned (bf16: tensor-map copies
// in and out; fp32: 16-byte loads and stores); with vec = 0 the same kernels
// stage and store element by element. Writes every element of df1 and df2.
// Launches on `stream` without synchronising; returns the launch's CUDA error
// code (0 on success).
int corr2d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
                    int H, int W, int C, int is_bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535 ||
      ((long long)W + band::kTX - 1) / band::kTX * ((C + band::kCC - 1) / band::kCC) >
          0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd::launch_bf16(f1, f2, g, df1, df2, B, H, W, C, vec != 0, s)
                 : corr::launch_bwd_fp32<kPH>(f1, f2, g, df1, df2, B, H, W, C, vec != 0, s);
}

}  // extern "C"
