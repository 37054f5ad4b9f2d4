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
// fp32: corr_tile.cuh's row tile on the CUDA cores: each channel chunk of
// f1's columns and of f2's columns with their 8-column halo is staged once
// through shared memory, and every shift reads it there.
//
// Backward (corr1d_backward). Replaces the lax VJP of the JAX package's
// _corr1d (ops/correlation.py:_corr1d_bwd_lax), which the TPU ran as XLA code
// beside the Pallas forward. With g = dL/dout:
//
//   df1[b,y,x,c]  = sum_d g[b,y,x,d]        * f2[b,y,x+d-8,c],
//   df2[b,y,x',c] = sum_d g[b,y,x'-d+8,d]   * f1[b,y,x'-d+8,c],
//
// zero terms outside [0,W). Both in gather form: each output element is one
// thread's sum, so there are no atomics and the result is deterministic.
// Bound: it must read f1, f2 and g and write df1 and df2 once; at the
// flagship's training shape per view, (8,32,64,352) bf16, that is 46.7 MB,
// 14 us at 3.35 TB/s, while the 0.4 GFLOP of products are far below the
// CUDA cores' rate. Design (a simple CUDA-core kernel; a tensor-core
// transposed band is later work): one block per (b, y) row, 32 columns and
// 32 channels stages the f1 and f2 windows with their 8-column halo (48
// columns, zero outside the image) and g's 48 x 17 window in shared memory as
// fp32; each thread owns one channel and 4 adjacent columns of both df1 and
// df2 (8 fp32 sums in registers), reads each of the 20 window columns of f1
// and f2 it needs once, and takes g as a warp-wide broadcast. Sums in fp32,
// stored in the input dtype.
#include "corr_band.cuh"
#include "corr_tile.cuh"

namespace {

// shared memory of a bf16 block: two blocks share an SM (its 228 KB less 1 KB
// reserved per block)
constexpr size_t kSmemBudget = 233472 / 2 - 1024;
constexpr int kBoxes = 3;   // 64-channel boxes per stage of the bf16 ring

template <typename T, bool kVec>
__global__ void __launch_bounds__(corr::kThreads, 4)
corr1d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int H, int W, int C) {
  using namespace corr;
  __shared__ __align__(16) float s1[kTX * kS];
  __shared__ __align__(16) float s2[kF2Rows * kS];
  const size_t row = (size_t)blockIdx.z * H + blockIdx.y;
  row_tile<T, kVec>(f1 + row * W * C, f2 + row * W * C, out + row * W * kPW, kPW,
                    blockIdx.x * kTX, W, C, s1, s2);
}

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

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
           cudaStream_t stream) {
  const dim3 grid((W + corr::kTX - 1) / corr::kTX, H, B);
  auto kernel = vec ? corr1d_kernel<T, true> : corr1d_kernel<T, false>;
  kernel<<<grid, corr::kThreads, 0, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                              static_cast<T*>(out), H, W, C);
  return (int)cudaGetLastError();
}

template <>
int launch<band::bf16>(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                       bool vec, cudaStream_t stream) {
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

constexpr int kBX = 32;                   // output columns per block
constexpr int kBC = 32;                   // channels per block: one warp's lanes
constexpr int kHalo = corr::kPW / 2;      // 8
constexpr int kWin = kBX + 2 * kHalo;     // window columns staged (48)
constexpr int kRun = 4;                   // adjacent output columns per thread
constexpr int kThreads = kBC * (kBX / kRun);  // 256

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const band::bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(band::bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr1d_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ g,
                  T* __restrict__ df1, T* __restrict__ df2, int H, int W, int C, int n_ctiles) {
  constexpr int kPW = corr::kPW;
  // window column j holds image column x0 - kHalo + j
  __shared__ float s1[kWin][kBC];
  __shared__ float s2[kWin][kBC];
  __shared__ float sg[kWin][kPW];
  const int x0 = (blockIdx.x / n_ctiles) * kBX;
  const int c0 = (blockIdx.x % n_ctiles) * kBC;
  const size_t row = (size_t)blockIdx.z * H + blockIdx.y;
  const size_t base = row * W * C;
  for (int i = threadIdx.x; i < kWin * kBC; i += kThreads) {
    const int j = i / kBC, c = i % kBC, x = x0 - kHalo + j;
    const bool in = x >= 0 && x < W && c0 + c < C;
    const size_t off = base + (size_t)x * C + c0 + c;
    s1[j][c] = in ? ld(f1 + off) : 0.f;
    s2[j][c] = in ? ld(f2 + off) : 0.f;
  }
  const T* grow = g + row * W * kPW;
  for (int i = threadIdx.x; i < kWin * kPW; i += kThreads) {
    const int j = i / kPW, d = i % kPW, x = x0 - kHalo + j;
    sg[j][d] = (x >= 0 && x < W) ? ld(grow + (size_t)x * kPW + d) : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % kBC;
  const int xs = (threadIdx.x / kBC) * kRun;  // this thread's first column, local
  float a1[kRun] = {}, a2[kRun] = {};
  // Output column xs + r (window column xs + r + kHalo) meets window column
  // xs + k: as f2 column x + d - 8 of df1's shift d = k - r, and as the
  // source column x' - d + 8 of df2's shift d = r - k + 2 * kHalo. Both
  // conditions are fixed at compile time once the loops unroll.
#pragma unroll
  for (int k = 0; k < kRun + 2 * kHalo; ++k) {
    const float v1 = s1[xs + k][c];
    const float v2 = s2[xs + k][c];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int d1 = k - r;
      if (d1 >= 0 && d1 < kPW) a1[r] = fmaf(sg[xs + r + kHalo][d1], v2, a1[r]);
      const int d2 = r - k + 2 * kHalo;
      if (d2 >= 0 && d2 < kPW) a2[r] = fmaf(sg[xs + k][d2], v1, a2[r]);
    }
  }
  if (c0 + c >= C) return;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int x = x0 + xs + r;
    if (x < W) {
      const size_t off = base + (size_t)x * C + c0 + c;
      st(df1 + off, a1[r]);
      st(df2 + off, a2[r]);
    }
  }
}

template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B, int H,
           int W, int C, cudaStream_t stream) {
  const int n_ctiles = (C + kBC - 1) / kBC;
  const dim3 grid(((W + kBX - 1) / kBX) * n_ctiles, H, B);
  corr1d_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(g),
      static_cast<T*>(df1), static_cast<T*>(df2), H, W, C, n_ctiles);
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
  return is_bf16 ? launch<band::bf16>(f1, f2, out, B, H, W, C, vec != 0, s)
                 : launch<float>(f1, f2, out, B, H, W, C, vec != 0, s);
}

// The gradients of corr1d_forward: f1, f2, df1, df2 contiguous (B,H,W,C), g
// contiguous (B,H,W,17), one dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// any alignment of the element type. Writes every element of df1 and df2.
// Launches on `stream` without synchronising; returns the launch's CUDA
// error code (0 on success).
int corr1d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
                    int H, int W, int C, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd::launch<band::bf16>(f1, f2, g, df1, df2, B, H, W, C, s)
                 : bwd::launch<float>(f1, f2, g, df1, df2, B, H, W, C, s);
}

}  // extern "C"
