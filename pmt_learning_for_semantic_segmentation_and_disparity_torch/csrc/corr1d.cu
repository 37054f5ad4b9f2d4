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
// once per shift (17 times). One block owns one (b, y) row and 64 output
// columns and runs the row tile of corr_tile.cuh on f1's and f2's row y: each
// channel chunk of f1's columns and of f2's columns with their 8-column halo
// is staged once through shared memory, and every shift reads it there.
#include "corr_tile.cuh"

namespace {

using namespace corr;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
corr1d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int H, int W, int C) {
  __shared__ __align__(16) float s1[kTX * kS];
  __shared__ __align__(16) float s2[kF2Rows * kS];
  const size_t row = (size_t)blockIdx.z * H + blockIdx.y;
  row_tile<T, kVec>(f1 + row * W * C, f2 + row * W * C, out + row * W * kPW, kPW,
                    blockIdx.x * kTX, W, C, s1, s2);
}

template <typename T>
void launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
            cudaStream_t stream) {
  const dim3 grid((W + kTX - 1) / kTX, H, B);
  auto kernel = vec ? corr1d_kernel<T, true> : corr1d_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                        static_cast<T*>(out), H, W, C);
}

}  // namespace

extern "C" {

// f1, f2: contiguous (B,H,W,C); out: contiguous (B,H,W,ph*pw) with
// (ph, pw) = (1, 17); same dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// vec: 16-byte loads (C a multiple of 16 / sizeof(dtype), pointers 16-byte
// aligned). Launches on `stream` without synchronising; returns
// cudaGetLastError() after the launch.
int corr1d_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int ph,
                   int pw, int is_bf16, int vec, void* stream) {
  if (ph != 1 || pw != kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 || B > 65535) {
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
