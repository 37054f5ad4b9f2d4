// The fp32 row tile shared by the correlation kernels (corr1d.cu, corr2d.cu);
// bf16 inputs take the tensor-core band tile of corr_band.cuh instead.
//
// One block of kThreads threads computes, for one row r1 of f1 and one row
// r2 of f2 (both of one image, NHWC), kTX = 64 output columns x kPW = 17
// horizontal shifts:
//
//   out[x, d] = sum_c r1[x, c] * r2[x + d - 8, c],  x in [x0, x0 + 64), d in [0, 17),
//
// zero where x + d - 8 falls outside [0, W); products and sums in fp32 on the
// CUDA cores (TF32 tensor cores would not hold fp32's tolerance). The 1-D
// kernel takes r2 = r1's row of f2; the 2-D kernel takes r2 = row y + i - 8
// for a vertical shift i.
//
// Design. The block walks the channels in chunks of kCC: each chunk of f1's
// 64 columns and of f2's 64 + 16 columns (the 8-column halo on each side,
// zero outside [0,W), so no padded copy of f2 is ever written to device
// memory) is staged once through shared memory as fp32. Every shift then
// reads shared memory only. Each thread owns kXPT = 4 adjacent columns and
// all 17 shifts (68 fp32 accumulators in registers), so one shared-memory
// read of f2 feeds up to 4 products; the kCG = 8 lanes that share a column
// group split the chunk's channels and are summed with warp shuffles at the
// end. The row stride kS = kCC + 2 keeps the shared-memory reads of a warp
// free of bank conflicts (4 column groups at row distance 4 land 8 banks
// apart; the 8 channel lanes fill the gaps).
// Not yet done for this fp32 tile: double-buffered staging (cp.async / TMA)
// to overlap the next chunk's loads with this chunk's products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace corr {

constexpr int kPW = 17;                  // horizontal shifts of a row tile
constexpr int kTX = 64;                  // output columns per block
constexpr int kXPT = 4;                  // output columns per thread
constexpr int kCG = 8;                   // lanes splitting one column group's channels
constexpr int kThreads = (kTX / kXPT) * kCG;  // 128
constexpr int kCC = 32;                  // channels staged per chunk
constexpr int kS = kCC + 2;              // shared-memory row stride in floats
constexpr int kF2Rows = kTX + kPW - 1;   // f2 columns a block needs (with halo)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Stage columns [x_begin, x_begin + rows) x channels [c0, c0 + kCC) of one
// image row into dst[r * kS + c] as fp32; zero outside [0, W) x [0, C).
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

// The block's row tile: r1, r2 point at column 0 of their rows; out[x, d]
// is stored at o + x * out_stride + d for x in [x0, min(x0 + kTX, W)).
// s1: kTX * kS floats, s2: kF2Rows * kS floats of shared memory.
template <typename T, bool kVec>
__device__ __forceinline__ void row_tile(const T* __restrict__ r1, const T* __restrict__ r2,
                                         T* __restrict__ o, int out_stride, int x0, int W, int C,
                                         float* s1, float* s2) {
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

  // The group's kXPT columns x kPW shifts: lane cg stores every kCG-th of
  // them, so the 8 lanes write each column's 17 outputs side by side.
#pragma unroll
  for (int n = 0; n < kXPT * kPW; ++n) {
    const int x = x0 + xl + n / kPW;
    if (n % kCG == cg && x < W) store(o + (size_t)x * out_stride + n % kPW, acc[n / kPW][n % kPW]);
  }
}

// A row tile whose f2 row lies outside the image: every output is zero.
template <typename T>
__device__ __forceinline__ void zero_tile(T* __restrict__ o, int out_stride, int x0, int W) {
  for (int n = threadIdx.x; n < kTX * kPW; n += kThreads) {
    const int x = x0 + n / kPW;
    if (x < W) store(o + (size_t)x * out_stride + n % kPW, 0.f);
  }
}

}  // namespace corr
