// 1-D horizontal patch correlation (stereo cost volume) for Hopper (sm_90a).
//
// Replaces the TPU kernel pmt_learning_for_semantic_segmentation_and_disparity_tpu/
// ops/correlation.py:_corr1d_kernel (correlation1d_pallas):
//
//   out[b,y,x,d] = sum_c f1[b,y,x,c] * f2[b,y,x+d-8,c],  d in [0,17),
//
// zero where x+d-8 falls outside [0,W). NHWC in, (B,H,W,17) out, products and
// sums in fp32, stored in the input dtype (fp32 or bf16).
//
// Bound. At the flagship shape f1 = f2 = (16,64,120,352) in bf16 the kernel
// must read f1 and f2 once (2 x 86.5 MB) and write the output once (4.2 MB):
// ~177 MB at 3.35 TB/s = ~53 us on an H100 SXM. The arithmetic is
// 2*16*64*120*17*352 = 1.5 GFLOP, far below the time memory takes, so the
// kernel is bound by bytes.
//
// Design. What matters for that bound is reading f2 once per tile instead of
// once per shift (17 times). One block owns one (b, y) row and kTX = 64
// output columns. It walks the channels in chunks of kCC: each chunk of f1's
// 64 columns and of f2's 64 + 16 columns (the 8-column halo on each side,
// zero outside [0,W), so no padded copy of f2 is ever written to device
// memory) is staged once through shared memory as fp32. Every shift then
// reads shared memory only. Each thread owns kXPT = 4 adjacent columns and
// all 17 shifts (68 fp32 accumulators in registers), so one shared-memory
// read of f2 feeds up to 4 products; the kCG = 8 lanes that share a column
// group split the chunk's channels and are summed with warp shuffles at the
// end. The 68 outputs of a column group are contiguous in memory, so the 8
// lanes store them interleaved. The row stride kS = kCC + 2 keeps the
// shared-memory reads of a warp free of bank conflicts (4 column groups at
// row distance 4 land 8 banks apart; the 8 channel lanes fill the gaps).
// Not yet done: double-buffered staging (cp.async / TMA) to overlap the next
// chunk's loads with this chunk's products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPW = 17;                  // shifts (patch width)
constexpr int kTX = 64;                  // output columns per block
constexpr int kXPT = 4;                  // output columns per thread
constexpr int kCG = 8;                   // lanes splitting one column group's channels
constexpr int kThreads = (kTX / kXPT) * kCG;  // 128
constexpr int kCC = 32;                  // channels staged per chunk
constexpr int kS = kCC + 2;              // shared-memory row stride in floats
constexpr int kF2Rows = kTX + kPW - 1;   // f2 columns a block needs (with halo)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Stage columns [x_begin, x_begin + rows) x channels [c0, c0 + kCC) of one
// (b, y) row into dst[r * kS + c] as fp32; zero outside [0, W) x [0, C).
// kVec: 16-byte loads, valid when C is a multiple of the vector width and the
// row pointer is 16-byte aligned (the wrapper checks both).
template <typename T, bool kVec>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ row,
                                      int x_begin, int rows, int W, int C, int c0) {
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kVPR = kCC / V;
    for (int i = threadIdx.x; i < rows * kVPR; i += kThreads) {
      const int r = i / kVPR;
      const int cl = (i % kVPR) * V;
      const int x = x_begin + r;
      const int c = c0 + cl;
      float v[V];
      if (x >= 0 && x < W && c < C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + (size_t)x * C + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = to_float(e[k]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = 0.f;
      }
      float* d = dst + r * kS + cl;
#pragma unroll
      for (int k = 0; k < V; k += 2) *reinterpret_cast<float2*>(d + k) = make_float2(v[k], v[k + 1]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kCC; i += kThreads) {
      const int r = i / kCC;
      const int cl = i % kCC;
      const int x = x_begin + r;
      const int c = c0 + cl;
      dst[r * kS + cl] = (x >= 0 && x < W && c < C) ? to_float(row[(size_t)x * C + c]) : 0.f;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
corr1d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int H, int W, int C) {
  __shared__ __align__(16) float s1[kTX * kS];
  __shared__ __align__(16) float s2[kF2Rows * kS];

  const int x0 = blockIdx.x * kTX;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = ((size_t)b * H + y) * (size_t)W;
  const T* r1 = f1 + row * C;
  const T* r2 = f2 + row * C;
  const int cg = threadIdx.x % kCG;
  const int xl = (threadIdx.x / kCG) * kXPT;

  float acc[kXPT][kPW];
#pragma unroll
  for (int i = 0; i < kXPT; ++i)
#pragma unroll
    for (int d = 0; d < kPW; ++d) acc[i][d] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    stage<T, kVec>(s1, r1, x0, kTX, W, C, c0);
    stage<T, kVec>(s2, r2, x0 - kPW / 2, kF2Rows, W, C, c0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCC / kCG; ++kk) {
      const int k = kk * kCG + cg;
      float a[kXPT];
      float v[kXPT + kPW - 1];
#pragma unroll
      for (int i = 0; i < kXPT; ++i) a[i] = s1[(xl + i) * kS + k];
#pragma unroll
      for (int j = 0; j < kXPT + kPW - 1; ++j) v[j] = s2[(xl + j) * kS + k];
#pragma unroll
      for (int i = 0; i < kXPT; ++i)
#pragma unroll
        for (int d = 0; d < kPW; ++d) acc[i][d] = fmaf(a[i], v[i + d], acc[i][d]);
    }
    __syncthreads();
  }

  // Sum over the kCG adjacent lanes that split this column group's channels.
#pragma unroll
  for (int i = 0; i < kXPT; ++i)
#pragma unroll
    for (int d = 0; d < kPW; ++d)
#pragma unroll
      for (int m = kCG / 2; m > 0; m >>= 1)
        acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], m);

  // The group's kXPT * kPW outputs are contiguous: lane cg stores every
  // kCG-th of them.
  T* o = out + (row + x0 + xl) * kPW;
#pragma unroll
  for (int n = 0; n < kXPT * kPW; ++n) {
    if (n % kCG == cg && x0 + xl + n / kPW < W) store(o + n, acc[n / kPW][n % kPW]);
  }
}

template <typename T>
void launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
            cudaStream_t stream) {
  const dim3 grid((W + kTX - 1) / kTX, H, B);
  if (vec) {
    corr1d_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<T*>(out), H, W, C);
  } else {
    corr1d_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<T*>(out), H, W, C);
  }
}

}  // namespace

extern "C" {

// Shifts the kernel is compiled for.
int corr1d_patch_width() { return kPW; }

// f1, f2: contiguous (B,H,W,C); out: contiguous (B,H,W,pw); same dtype,
// fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). vec: 16-byte loads (C a multiple
// of 16 / sizeof(dtype), pointers 16-byte aligned). Launches on `stream`
// without synchronising; returns cudaGetLastError() after the launch.
int corr1d_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int pw,
                   int is_bf16, int vec, void* stream) {
  if (pw != kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(f1, f2, out, B, H, W, C, vec != 0, s);
  } else {
    launch<float>(f1, f2, out, B, H, W, C, vec != 0, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
