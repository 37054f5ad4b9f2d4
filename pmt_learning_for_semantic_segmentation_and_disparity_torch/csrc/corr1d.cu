// 1-D horizontal patch correlation (stereo cost volume) for Hopper (sm_90a).
//
// Replaces the TPU kernel pmt_learning_for_semantic_segmentation_and_disparity_tpu/
// ops/correlation.py:_corr1d_kernel (correlation1d_pallas):
//
//   out[b,y,x,d] = sum_c f1[b,y,x,c] * f2[b,y,x+d-8,c],  d in [0,17),
//
// zero where x+d-8 falls outside [0,W). NHWC in, (B,H,W,17) out, sums in
// fp32, stored in the input dtype (fp32 or bf16).
//
// Bound. At the flagship shape f1 = f2 = (16,64,120,352) in bf16 the kernel
// must read f1 and f2 once (2 x 86.5 MB) and write the output once (4.2 MB):
// ~177 MB at 3.35 TB/s = ~53 us on an H100 SXM. The arithmetic is
// 2*16*64*120*17*352 = 1.5 GFLOP (2.8 GFLOP as the band tile does it, 3 us
// at the bf16 tensor-core peak), so the kernel is bound by bytes, and what
// matters is keeping enough of them in flight to hold HBM busy.
//
// bf16: the band tile of corr_band.cuh with the single f2 row r = y. One
// block owns one (b, y) row and 64 columns. The copy engine brings f1's tile
// (6 boxes of 64 channels x 64 columns at C = 352, resident) and f2's window
// (64 channels x 80 columns per box) in boxes of 64 channels, 3 boxes to a
// stage of a 2-stage ring, so all of a block's 108 KB are in flight at once
// and two blocks share an SM: what HBM needs to stay busy. The L2 reads are
// f1 once and f2's windows once (136 columns for a row of 120 at the
// flagship shape, 98 MB).
// The halo and the channel tail are zero-filled by the copy engine, no chunk
// is widened to fp32 in shared memory, and each warp stores its bands
// straight from the accumulators.
//
// fp32 (corr_tile.cuh's corr1d_fp32_kernel, on the CUDA cores): bound by
// bytes too, 2 x 173 MB + 8.4 MB at the flagship shape, 0.1058 ms. A block
// owns a row tile of 64 columns; 32-channel stages of f1's 64 and f2's 80
// columns come in by 16-byte cp.async copies through a 4-stage ring (3 in
// flight, 3 blocks an SM), and a thread sums 4 columns x 17 shifts of one
// quad of each stage in registers. Every fp32 input takes this kernel: vec
// inputs by cp.async, the rest (C % 4 != 0, or off 16-byte alignment) by
// element loads into the same layout.
//
// Backward (corr1d_backward). Replaces the lax VJP of the JAX package's
// _corr1d (ops/correlation.py:_corr1d_bwd_lax), which the TPU ran as XLA code
// beside the Pallas forward. With g = dL/dout:
//
//   df1[b,y,x,c]  = sum_d g[b,y,x,d]        * f2[b,y,x+d-8,c],
//   df2[b,y,x',c] = sum_d g[b,y,x'-d+8,d]   * f1[b,y,x'-d+8,c],
//
// zero terms outside [0,W). Each output element is one sum, owned by one
// thread: no atomics, deterministic.
//
// Bound: it must read f1, f2 and g and write df1 and df2 once; at the
// flagship's training shape per view, (8,32,64,352) bf16, that is 46.7 MB,
// 14 us at 3.35 TB/s, half of it written. The 0.39 GFLOP of useful products
// are 0.4 us on the tensor cores. So it is bound by bytes, the stores as much
// as the loads; at 46.7 MB the working set nearly fills the 50 MB L2, so back
// to back launches run warmer than the training step's.
//
// bf16: a transposed band on the tensor cores. Fix one image row (b, y) and a
// tile of 64 output columns x0 .. x0+63; window column k in [0, 80) is image
// column x0-8+k, and F1w, F2w are f1's and f2's 80-column windows (zero
// outside [0, W) and past C). For the 16-column slab m in {0,1,2,3}, with r
// the tile's output column in [16m, 16m+16) and k in [16m, 16m+32):
//
//   df1[x0+r, :] = sum_k A1[r,k] * F2w[k, :],  A1[r,k] = g[x0+r,   k-r]
//   df2[x0+r, :] = sum_k A2[r,k] * F1w[k, :],  A2[r,k] = g[x0-8+k, r-k+16]
//
// both zero unless 0 <= k-r <= 16 (and g read as zero outside [0, W)): a
// 16 x 32 A tile, two m16n8k16 k-steps, 32/17 = 1.9x the useful products.
// One block per (b, y, tile): 8 consumer warps, warp w takes slab w % 4 of
// df1 (w < 4, B from F2w) or of df2 (w >= 4, B from F1w), and 1 producer
// warp. The producer walks the 64-channel boxes through a ring of stages
// (corr_band.cuh's mbarrier protocol), one tiled TMA copy of F1w's and one of
// F2w's 80 x 64 box per stage, in the 128-byte swizzle; the copy engine
// zero-fills the halo and the channel tail. g's 80 x 17 window (its 34-byte
// pixel stride is no tensor-map stride) is read once per block with element
// loads, and each consumer warp builds its A fragments from it once, in
// registers, with the band mask applied: 8 registers reused for every box.
// B fragments come from the box with ldmatrix.x4.trans (K = window column
// runs along the box's rows; 8 consecutive columns are 8 distinct swizzle
// rows, so no bank conflicts). The sum runs over k, inside one box, so each
// box's 16 x 64 slab is finished at once: converted to bf16 into the warp's
// swizzled 2 KB output box (two of them, alternating) and written out with a
// TMA store of 16 columns x 64 channels, which drops columns >= W and channels
// >= C; the warp waits for the store's reads only before reusing that box.
// Inputs a tensor map cannot take (vec = 0: C % 8 != 0, or a pointer off
// 16-byte alignment) take the same kernel with the producer staging both
// windows by element loads into the same layout and the consumers storing by
// element stores.
//
// fp32 (no TF32: it would break the 1e-4 tolerance): corr_tile.cuh's backward
// tile, on the CUDA cores in gather form. A block stages 80
// columns x 64 channels of f1 and f2 (64 output columns with the 8-column
// halo) and g's 80 x 17 window in shared memory; a thread owns 4 adjacent
// channels (one float4 of the window) of 4 adjacent columns of df1 and df2,
// so each broadcast of a g value feeds 4 FMAs.
#include "corr_band.cuh"
#include "corr_tile.cuh"

namespace {

// shared memory of a bf16 block: two blocks share an SM (its 228 KB less 1 KB
// reserved per block)
constexpr size_t kSmemBudget = 233472 / 2 - 1024;
constexpr int kBoxes = 3;   // 64-channel boxes per stage of the bf16 ring

template <bool kTma>
__global__ void __launch_bounds__(band::kThreads, 2)
corr1d_band_kernel(const __grid_constant__ CUtensorMap tm1, const __grid_constant__ CUtensorMap tm2,
                   const band::bf16* __restrict__ f1, const band::bf16* __restrict__ f2,
                   band::bf16* __restrict__ out, int H, int W, int C, int ns, int kb, int f1_res) {
  extern __shared__ unsigned char smem[];
  const size_t img = (size_t)blockIdx.z * H * W;
  band::band_tile<1, kTma>(&tm1, &tm2, f1 + img * C, f2 + img * C, out + img * band::kPW,
                           blockIdx.z, blockIdx.y, blockIdx.x * band::kTX, H, W, C, 1, ns, kb,
                           f1_res != 0, smem);
}

int launch_bf16(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
                cudaStream_t stream) {
  const band::Plan p = band::plan(C, 1, kBoxes, kSmemBudget);
  // vec (C a multiple of 8, 16-byte aligned inputs) is what a tensor map takes
  CUtensorMap tm1{}, tm2{};
  if (vec) {
    cudaError_t err = band::tensor_map(&tm1, f1, B, H, W, C, band::kTX);
    if (err == cudaSuccess) err = band::tensor_map(&tm2, f2, B, H, W, C, band::kWin);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = vec ? corr1d_band_kernel<true> : corr1d_band_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + band::kTX - 1) / band::kTX, H, B);
  kernel<<<grid, band::kThreads, p.smem, stream>>>(
      tm1, tm2, static_cast<const band::bf16*>(f1), static_cast<const band::bf16*>(f2),
      static_cast<band::bf16*>(out), H, W, C, p.ns, p.kb, (int)p.f1_res);
  return (int)cudaGetLastError();
}

namespace bwd {

using band::bf16;
constexpr int kPW = band::kPW;
constexpr int kHalo = kPW / 2;            // 8
constexpr int kCC = band::kCC;            // channels per box

// ---- bf16: the transposed band ----
constexpr int kSlab = 16;                 // output columns per consumer warp
constexpr int kWinBox = band::kF2Box;     // one window box: 80 columns x 64 channels (10 KB)
constexpr int kOutBox = kSlab * kCC * 2;  // one warp's output box: 16 columns x 64 channels (2 KB)
constexpr int kGBytes = (band::kWin * kPW * 2 + 127) / 128 * 128;  // g's 80 x 17 window
// channel groups a row tile's boxes are split over, one block each: one
// block walks all of them (2, 3 or 6 groups measured slower, PERF.md §6)
constexpr int kGroups = 1;

// [ns stages: F1w box, F2w box][2 output boxes per consumer warp][g][barriers],
// with 1 KB of slack to align the boxes to the swizzle's 1024 bytes
inline size_t smem_bytes(int ns) {
  return 1024 + (size_t)ns * 2 * kWinBox + band::kConsumers * 2 * kOutBox + kGBytes +
         2 * band::kMaxStages * 8;
}

template <bool kTma>
__global__ void __launch_bounds__(band::kThreads, 2)
corr1d_bwd_band_kernel(const __grid_constant__ CUtensorMap tm1,
                       const __grid_constant__ CUtensorMap tm2,
                       const __grid_constant__ CUtensorMap td1,
                       const __grid_constant__ CUtensorMap td2, const bf16* __restrict__ f1,
                       const bf16* __restrict__ f2, const bf16* __restrict__ g,
                       bf16* __restrict__ df1, bf16* __restrict__ df2, int H, int W, int C,
                       int groups, int ns) {
  using namespace band;
  extern __shared__ unsigned char smem_raw[];
  const int nb = (C + kCC - 1) / kCC;
  const int per = (nb + groups - 1) / groups;  // boxes per channel group
  const int q0 = (blockIdx.x % groups) * per;
  const int items = min(nb, q0 + per) - q0;    // this block's boxes
  if (items <= 0) return;
  const int x0 = (blockIdx.x / groups) * kTX;
  const int y = blockIdx.y, b = blockIdx.z;
  const size_t row = ((size_t)b * H + y) * W;  // the row's first pixel

  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* obox = ring + (size_t)ns * 2 * kWinBox;
  bf16* sg = reinterpret_cast<bf16*>(obox + kConsumers * 2 * kOutBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(obox + kConsumers * 2 * kOutBox + kGBytes);
  uint64_t* empty = full + kMaxStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: stage j = box q0 + j, F1w then F2w ----
    for (int j = 0; j < items; ++j) {
      const int s = j % ns;
      const int u = j / ns;
      if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);  // the consumers have released it
      unsigned char* st = ring + (size_t)s * 2 * kWinBox;
      const int c0 = (q0 + j) * kCC;
      if (kTma) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kWinBox);
          tma_load(st, &tm1, c0, x0 - kHalo, y, b, &full[s]);
          tma_load(st + kWinBox, &tm2, c0, x0 - kHalo, y, b, &full[s]);
        }
      } else {
        copy_box(st, f1 + row * C, x0 - kHalo, kWin, W, C, c0, lane);
        copy_box(st + kWinBox, f2 + row * C, x0 - kHalo, kWin, W, C, c0, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers ----
  // g's window: column j is image column x0 - 8 + j, zero outside [0, W)
  for (int i = threadIdx.x; i < kWin * kPW; i += kConsumers * 32) {
    const int x = x0 - kHalo + i / kPW;
    sg[i] = (x >= 0 && x < W) ? g[(row + x) * kPW + i % kPW] : __float2bfloat16(0.f);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");  // consumers only

  const int m = warp & 3;       // slab: output columns 16m .. 16m+15 of the tile
  const int t = warp >> 2;      // 0: df1 (B from F2w), 1: df2 (B from F1w)
  const int gid = lane >> 2, tig = lane & 3;
  // A fragments of the slab's two k-steps (k = 16m + kk, kk in [0, 32)):
  // register i holds row gid + 8(i&1), columns 8(i>>1) + 2 tig + {0, 1}
  uint32_t afrag[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gid + 8 * (i & 1);  // slab-local output column
      bf16 v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 16 * ks + 8 * (i >> 1) + 2 * tig + e;
        const int dd = kk - r;  // k - r: df1's shift, 16 - df2's
        v[e] = __float2bfloat16(0.f);
        if (dd >= 0 && dd < kPW)
          v[e] = t == 0 ? sg[(16 * m + r + kHalo) * kPW + dd] : sg[(16 * m + kk) * kPW + kPW - 1 - dd];
      }
      const __nv_bfloat162 p = __halves2bfloat162(v[0], v[1]);
      afrag[ks][i] = *reinterpret_cast<const uint32_t*>(&p);
    }
  // ldmatrix.trans rows of this lane: window column 16m + 16ks + kr, channels
  // 16np + cb .. +7 (matrices: k 0-7 / 8-15 x channels 0-7 / 8-15)
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int cb = (lane >> 4) * 8;

  for (int j = 0; j < items; ++j) {
    const int s = j % ns;
    mbar_wait(&full[s], (j / ns) & 1);
    const uint32_t bx = smem_u32(ring + (size_t)s * 2 * kWinBox + (t == 0 ? kWinBox : 0));
    float acc[kCC / 8][4];
#pragma unroll
    for (int n = 0; n < kCC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < kCC / 16; ++np) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, bx + swz(16 * m + 16 * ks + kr, 16 * np + cb));
        mma_bf16(acc[2 * np], afrag[ks], bfrag[0], bfrag[1]);
        mma_bf16(acc[2 * np + 1], afrag[ks], bfrag[2], bfrag[3]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s

    // the slab of box q0 + j is complete: accumulator (row, column) of n-tile
    // n is output column x0 + 16m + row, channel c0 + 8n + column
    const int c0 = (q0 + j) * kCC;
    if (x0 + 16 * m >= W) continue;  // the whole slab lies past the image
    if (kTma) {
      // the two boxes of each tensor hold its 4 slabs side by side
      unsigned char* ob = obox + ((t * 2 + (j & 1)) * 4 + m) * kOutBox;
      if (lane == 0) bulk_wait_read<1>();  // the store of box j - 2 has read ob
      __syncwarp();
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
      }
    } else {
      bf16* out = (t == 0 ? df1 : df2) + row * C;
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
  if (kTma && lane == 0) bulk_wait<0>();  // the stores are done before the block ends
}

int launch_bf16(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B, int H,
                int W, int C, bool vec, cudaStream_t stream) {
  const int nb = (C + kCC - 1) / kCC;
  const int per = (nb + min(kGroups, nb) - 1) / min(kGroups, nb);
  const int groups = (nb + per - 1) / per;  // no group left empty
  int ns = min(per, band::kMaxStages);
  while (ns > 1 && smem_bytes(ns) > kSmemBudget) --ns;
  // vec (C a multiple of 8, 16-byte aligned tensors) is what a tensor map takes
  CUtensorMap tm1{}, tm2{}, td1{}, td2{};
  if (vec) {
    cudaError_t err = band::tensor_map(&tm1, f1, B, H, W, C, band::kWin);
    if (err == cudaSuccess) err = band::tensor_map(&tm2, f2, B, H, W, C, band::kWin);
    if (err == cudaSuccess) err = band::tensor_map(&td1, df1, B, H, W, C, kSlab);
    if (err == cudaSuccess) err = band::tensor_map(&td2, df2, B, H, W, C, kSlab);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = vec ? corr1d_bwd_band_kernel<true> : corr1d_bwd_band_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes(ns));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((W + band::kTX - 1) / band::kTX) * groups, H, B);
  kernel<<<grid, band::kThreads, smem_bytes(ns), stream>>>(
      tm1, tm2, td1, td2, static_cast<const bf16*>(f1), static_cast<const bf16*>(f2),
      static_cast<const bf16*>(g), static_cast<bf16*>(df1), static_cast<bf16*>(df2), H, W, C,
      groups, ns);
  return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

extern "C" {

// f1, f2: contiguous (B,H,W,C); out: contiguous (B,H,W,ph*pw) with
// (ph, pw) = (1, 17); same dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// vec: 16-byte loads (C a multiple of 16 / sizeof(dtype), pointers 16-byte
// aligned). Launches on `stream` without synchronising; returns the launch's
// CUDA error code (0 on success).
int corr1d_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int ph,
                   int pw, int is_bf16, int vec, void* stream) {
  if (ph != 1 || pw != corr::kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(f1, f2, out, B, H, W, C, vec != 0, s)
                 : corr::launch_fwd_fp32(f1, f2, out, B, H, W, C, vec != 0, s);
}

// The plan the bf16 band's launch takes for C channels: out = {stages,
// 64-channel boxes a stage, f1 resident in shared memory, dynamic shared
// memory bytes}.
void corr1d_forward_plan(int C, int* out) {
  const band::Plan p = band::plan(C, 1, kBoxes, kSmemBudget);
  out[0] = p.ns, out[1] = p.kb, out[2] = (int)p.f1_res, out[3] = (int)p.smem;
}

// The gradients of corr1d_forward: f1, f2, df1, df2 contiguous (B,H,W,C), g
// contiguous (B,H,W,17), one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// any alignment of the element type. vec: C a multiple of 16 / sizeof(dtype)
// and f1, f2, df1, df2 16-byte aligned (bf16: tensor-map copies in and out;
// fp32: 16-byte loads and stores); with vec = 0 the same kernels stage and
// store element by element. Writes every element of df1 and df2. Launches on
// `stream` without synchronising; returns the launch's CUDA error code (0 on
// success).
int corr1d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
                    int H, int W, int C, int is_bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd::launch_bf16(f1, f2, g, df1, df2, B, H, W, C, vec != 0, s)
                 : corr::launch_bwd_fp32(f1, f2, g, df1, df2, B, H, W, C, vec != 0, s);
}

}  // extern "C"
