// corr1d's fp32 tiles (corr1d.cu), on the CUDA cores; bf16 inputs take the
// tensor-core band tiles of corr_band.cuh instead, and corr2d's fp32 kernels
// are corr2d.cu's own.
//
// The row tile: one block of kThreads threads computes, for one image row
// (NHWC) of f1 and the same row of f2, kTX = 64 output columns x kPW = 17
// horizontal shifts:
//
//   out[x, d] = sum_c f1[x, c] * f2[x + d - 8, c],  x in [x0, x0 + 64), d in [0, 17),
//
// zero where x + d - 8 falls outside [0, W); products and sums in fp32 on the
// CUDA cores (TF32 tensor cores would not hold fp32's tolerance).
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
// apart; the 8 channel lanes fill the gaps). The staging is single-buffered;
// at 52-65% of its bound (PERF.md §6) the tile was left as it is.
//
// The backward tile (bwd_fp32_kernel, below), in gather form on the CUDA
// cores. With g = dL/dout (17 values a pixel):
//
//   df1[b,y,x,c] = sum_d g[b,y,x,d]        * f2[b,y,x+d-8,c],
//   df2[b,y,x,c] = sum_d g[b,y,x-d+8,d]    * f1[b,y,x-d+8,c],
//
// zero terms outside the image. A block owns 64 columns x 64 channels of one
// row of df1 and df2; it stages 80 columns (64 with the 8-column halo) x 64
// channels of f1's and f2's row, and g's 80 x 17 window, in shared memory; a
// thread owns 4 adjacent channels (one float4) of 4 adjacent columns of df1
// and df2, so each broadcast of a g value feeds 4 FMAs. Each output element
// is one sum, owned by one thread: no atomics, deterministic.
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

// ---- the fp32 backward tile ----
constexpr int kBX = 64;                   // output columns per block
constexpr int kBC = 64;                   // channels per block
constexpr int kHalo = kPW / 2;            // 8
constexpr int kBWin = kBX + 2 * kHalo;    // window columns staged (80)
constexpr int kRun = 4;                   // adjacent output columns per thread
constexpr int kQ = 4;                     // adjacent channels per thread: one float4
constexpr int kBThreads = (kBC / kQ) * (kBX / kRun);  // 256

// dynamic shared memory of bwd_fp32_kernel: the f1 and f2 windows, and g's
constexpr size_t kBwdSmem = (2 * kBWin * kBC + kBWin * kPW) * sizeof(float);

// grid (column tiles x channel tiles, H, B), kBThreads threads, kBwdSmem
// bytes. kVec: C a multiple of 4 and 16-byte aligned tensors, so a quad of
// channels is all in or all out of [0, C).
template <bool kVec>
__global__ void __launch_bounds__(kBThreads)
bwd_fp32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ g, float* __restrict__ df1, float* __restrict__ df2,
                int H, int W, int C, int n_ctiles) {
  // window column j holds image column x0 - kHalo + j
  extern __shared__ __align__(16) float bwd_smem[];
  float (*s1)[kBC] = reinterpret_cast<float (*)[kBC]>(bwd_smem);
  float (*s2)[kBC] = s1 + kBWin;
  float (*sg)[kPW] = reinterpret_cast<float (*)[kPW]>(s2 + kBWin);  // g of row y
  const int x0 = (blockIdx.x / n_ctiles) * kBX;
  const int c0 = (blockIdx.x % n_ctiles) * kBC;
  const int y = blockIdx.y;
  const size_t img = (size_t)blockIdx.z * H;
  const int c = (threadIdx.x % (kBC / kQ)) * kQ;
  const int xs = (threadIdx.x / (kBC / kQ)) * kRun;  // this thread's first column, local
  float4 a1[kRun], a2[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) a1[r] = a2[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  {
    const size_t base = (img + y) * W * C;
    for (int n = threadIdx.x; n < kBWin * kBC / kQ; n += kBThreads) {
      const int j = n / (kBC / kQ), cq = (n % (kBC / kQ)) * kQ, x = x0 - kHalo + j;
      const bool in = x >= 0 && x < W;
      float4 v1 = make_float4(0.f, 0.f, 0.f, 0.f), v2 = v1;
      if (kVec) {
        if (in && c0 + cq < C) {
          v1 = *reinterpret_cast<const float4*>(f1 + base + (size_t)x * C + c0 + cq);
          v2 = *reinterpret_cast<const float4*>(f2 + base + (size_t)x * C + c0 + cq);
        }
      } else {
        float* p1 = &v1.x;
        float* p2 = &v2.x;
#pragma unroll
        for (int e = 0; e < kQ; ++e)
          if (in && c0 + cq + e < C) {
            p1[e] = f1[base + (size_t)x * C + c0 + cq + e];
            p2[e] = f2[base + (size_t)x * C + c0 + cq + e];
          }
      }
      *reinterpret_cast<float4*>(&s1[j][cq]) = v1;
      *reinterpret_cast<float4*>(&s2[j][cq]) = v2;
    }
    for (int n = threadIdx.x; n < kBWin * kPW; n += kBThreads) {
      const int j = n / kPW, d = n % kPW, x = x0 - kHalo + j;
      sg[j][d] = x >= 0 && x < W ? g[((img + y) * W + x) * kPW + d] : 0.f;
    }
    __syncthreads();

    // Output column xs + r (window column xs + r + kHalo) meets window
    // column xs + k: as f2 column x + d - 8 of df1's shift d = k - r, and as
    // the source column x' - d + 8 of df2's shift d = r - k + 2 * kHalo.
    // Both conditions are fixed at compile time once the loops unroll.
#pragma unroll
    for (int k = 0; k < kRun + 2 * kHalo; ++k) {
      const float4 v1 = *reinterpret_cast<const float4*>(&s1[xs + k][c]);
      const float4 v2 = *reinterpret_cast<const float4*>(&s2[xs + k][c]);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int d1 = k - r;
        if (d1 >= 0 && d1 < kPW) {
          const float w = sg[xs + r + kHalo][d1];
          a1[r].x = fmaf(w, v2.x, a1[r].x);
          a1[r].y = fmaf(w, v2.y, a1[r].y);
          a1[r].z = fmaf(w, v2.z, a1[r].z);
          a1[r].w = fmaf(w, v2.w, a1[r].w);
        }
        const int d2 = r - k + 2 * kHalo;
        if (d2 >= 0 && d2 < kPW) {
          const float w = sg[xs + k][d2];
          a2[r].x = fmaf(w, v1.x, a2[r].x);
          a2[r].y = fmaf(w, v1.y, a2[r].y);
          a2[r].z = fmaf(w, v1.z, a2[r].z);
          a2[r].w = fmaf(w, v1.w, a2[r].w);
        }
      }
    }
  }
  const size_t base = (img + y) * W * C;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int x = x0 + xs + r;
    if (x >= W) continue;
    const size_t off = base + (size_t)x * C + c0 + c;
    if (kVec) {
      if (c0 + c < C) {
        *reinterpret_cast<float4*>(df1 + off) = a1[r];
        *reinterpret_cast<float4*>(df2 + off) = a2[r];
      }
    } else {
      const float* p1 = &a1[r].x;
      const float* p2 = &a2[r].x;
#pragma unroll
      for (int e = 0; e < kQ; ++e)
        if (c0 + c + e < C) {
          df1[off + e] = p1[e];
          df2[off + e] = p2[e];
        }
    }
  }
}

inline int launch_bwd_fp32(const void* f1, const void* f2, const void* g, void* df1, void* df2,
                           int B, int H, int W, int C, bool vec, cudaStream_t stream) {
  const int n_ctiles = (C + kBC - 1) / kBC;
  const dim3 grid(((W + kBX - 1) / kBX) * n_ctiles, H, B);
  auto kernel = vec ? bwd_fp32_kernel<true> : bwd_fp32_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kBThreads, kBwdSmem, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<const float*>(g),
      static_cast<float*>(df1), static_cast<float*>(df2), H, W, C, n_ctiles);
  return (int)cudaGetLastError();
}

}  // namespace corr
