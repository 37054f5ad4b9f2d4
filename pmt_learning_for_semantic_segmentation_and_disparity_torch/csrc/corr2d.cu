// 17x17 patch correlation (stereo cost volume) for Hopper (sm_90a).
//
// Replaces the TPU kernel pmt_learning_for_semantic_segmentation_and_disparity_tpu/
// ops/correlation.py:_corr2d_kernel (correlation2d_pallas):
//
//   out[b,y,x,i*17+j] = sum_c f1[b,y,x,c] * f2[b,y+i-8,x+j-8,c],  i, j in [0,17),
//
// zero where (y+i-8, x+j-8) falls outside [0,H) x [0,W). NHWC in,
// (B,H,W,289) out, products and sums in fp32, stored in the input dtype (fp32
// or bf16). The division by C of the normalized variant stays outside.
//
// Bound. At the sdnet shape f1 = f2 = (16,64,120,352) in bf16 the kernel must
// read f1 and f2 once (2 x 86.5 MB) and write the output once (71.0 MB):
// ~244 MB at 3.35 TB/s = ~73 us on an H100 SXM. The arithmetic is
// 2*16*64*120*289*352 = 25.0 GFLOP: 25 us at the 989 TFLOP/s bf16 tensor-core
// peak, so the bound is the bytes. This kernel does its products as fp32 FMAs
// on the CUDA cores, which cannot go below 25.0 GFLOP / 67 TFLOP/s = ~0.37 ms,
// about 5x the bound; a tensor-core design (a banded product per vertical
// shift, as correlation2d_matmul does for the TPU's matrix unit) is what can
// reach it.
//
// Design. A pixel has 289 sums, too many for one thread's registers, and
// corr_tile.cuh's row tile already spends 68 accumulators on 4 columns x 17
// horizontal shifts. So the 17 vertical shifts are split across blocks: the
// grid is (column tiles x 17, H, B), block (t*17 + i, y, b) runs the row tile
// of f1's row y against f2's row y+i-8 and writes outputs [i*17, i*17+17) of
// each of its pixels; a block whose f2 row lies outside [0,H) writes zeros and
// stages nothing. The TPU kernel's 128-lane channel padding and its padded
// copy of f2 in device memory have no counterpart: the row tile zero-fills the
// column halo and the channel tail while it stages into shared memory.
//
// Cost of that split in bytes re-read from L2: every f1 tile is staged by its
// 17 blocks and every f2 row by the 17 output rows that reach it, about 17 x
// (86.5 + 98) MB = ~3 GB at the sdnet shape against the 0.17 GB the inputs
// hold. The 17 blocks of one tile are neighbours in launch order (blockIdx.x
// is fastest), and the f2 rows that one output row reaches (17 x 120 x 352 x
// 2 B = 1.4 MB per image) stay in the 50 MB L2, so device memory sees each
// input about once.
#include "corr_tile.cuh"

namespace {

using namespace corr;

constexpr int kPH = 17;                  // vertical shifts
constexpr int kPatch = kPH * kPW;        // 289 outputs per pixel

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
corr2d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
              int H, int W, int C) {
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

template <typename T>
void launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, bool vec,
            cudaStream_t stream) {
  const dim3 grid(((W + kTX - 1) / kTX) * kPH, H, B);
  auto kernel = vec ? corr2d_kernel<T, true> : corr2d_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                        static_cast<T*>(out), H, W, C);
}

}  // namespace

extern "C" {

// f1, f2: contiguous (B,H,W,C); out: contiguous (B,H,W,ph*pw) with
// (ph, pw) = (17, 17); same dtype, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// vec: 16-byte loads (C a multiple of 16 / sizeof(dtype), pointers 16-byte
// aligned). Launches on `stream` without synchronising; returns
// cudaGetLastError() after the launch.
int corr2d_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int ph,
                   int pw, int is_bf16, int vec, void* stream) {
  if (ph != kPH || pw != kPW || B <= 0 || H <= 0 || W <= 0 || C <= 0 || H > 65535 ||
      B > 65535 || ((long long)W + kTX - 1) / kTX * kPH > 0x7fffffffLL) {
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
