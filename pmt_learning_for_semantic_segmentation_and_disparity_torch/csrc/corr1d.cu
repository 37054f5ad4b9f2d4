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

}  // extern "C"
