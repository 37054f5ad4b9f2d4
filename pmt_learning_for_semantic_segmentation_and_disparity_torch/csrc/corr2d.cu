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

}  // extern "C"
