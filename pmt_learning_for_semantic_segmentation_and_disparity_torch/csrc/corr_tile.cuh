// corr1d's fp32 kernels (corr1d.cu), on the CUDA cores; bf16 inputs take the
// tensor-core band tiles of corr_band.cuh instead, and corr2d's fp32 kernels
// are corr2d.cu's own.
//
// The forward (corr1d_fp32_kernel). Replaces the fp32 case of the TPU kernel
// pmt_learning_for_semantic_segmentation_and_disparity_tpu/ops/
// correlation.py:_corr1d_kernel:
//
//   out[b,y,x,d] = sum_c f1[b,y,x,c] * f2[b,y,x+d-8,c],  d in [0,17),
//
// zero where x+d-8 falls outside [0,W); products and sums in fp32 FMAs on the
// CUDA cores (TF32 tensor cores would not hold fp32's tolerance).
//
// Bound: bytes. It must read f1 and f2 once and write the output once:
// (8,32,64,352), a view of the training step, 47.3 MB, 0.0141 ms at
// 3.35 TB/s; (1,64,120,352), an eval row, 22.1 MB, 0.0066 ms; (16,64,120,352),
// serving, 354.4 MB, 0.1058 ms. Its FMAs (0.10 G at the training shape) take
// 0.003 ms at the 67 TFLOP/s fp32 peak. So what matters is keeping bytes in
// flight on every SM.
//
// Design. A block owns a row tile: 64 output columns of one image row
// (b, y); it reads f1's 64 columns and f2's 80 (the 8-column halo each side,
// zero outside [0,W), so no padded copy of f2 is written). The channels come
// in stages of 32: a stage holds the 32 channels of all 144 columns, 18,432
// bytes, each column's 128 bytes as a row of 8 16-byte quads. Every thread
// issues 16-byte cp.async copies of 9 quads a stage (zero-filled outside the
// image and past C) into a ring of 4 stages, so three stages are in flight
// while one is summed, with one barrier a stage: 73,728 bytes a block, 3
// blocks an SM, ~166 KB in flight on an SM. A block of 128 threads: thread t
// owns the 4 adjacent columns 4(t/8) .. +3 and all 17 shifts (68 fp32 sums
// in registers) and, of each stage, the quad t % 8: it reads its 4 f1 values
// and 20 f2 window columns as 16-byte loads, 24 loads for 272 FMAs.
// The 8 lanes of a load phase read one column's 8 quads, 128 contiguous
// bytes: no bank conflict and no pad. At the end the 8 lanes that split a
// column group's channels are summed by a butterfly of warp shuffles, the
// sums go through the ring into a 64 x 17 tile, and the tile's outputs, one
// run of 17 x columns floats in the output, are stored by consecutive
// threads. Every output has one owner: deterministic.
// Which inputs take which path: one kernel for every shape; vec (C % 4 == 0,
// f1 and f2 16-byte aligned) copies with cp.async, any other input stages the
// same layout by element loads (kVec = false).
// What holds it (tools/probe_band.py --fp32 corr1d on an H100 SXM at 700 W,
// PERF.md section 6): the copies. With the products cut out it takes 0.1284
// of its 0.1332 ms at serving (the copies at 82% of the byte bound), 0.0227
// of 0.0242 ms at the training step's shape; at an eval row's (128 blocks
// for 132 SMs) copies and products take about as long alone (0.0087 and
// 0.0104 of 0.0115 ms).
// Tried and measured slower or no faster: a cluster of 2 or 4 CTAs splitting
// a tile's stages, summed through distributed shared memory (0.0174 ms
// against 0.0129 at the eval row); rings of 2, 3 and 6 stages; 16 lanes a
// column group with 64-channel stages; an L2 prefetch of the tile's pixels;
// 256-byte L2 fetches; 32-column tiles were within 1-4%.
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

#include "corr_band.cuh"

namespace corr {

using band::cp_async16;
using band::cp_async_commit;
using band::cp_async_wait;
using band::load4;

constexpr int kPW = 17;                  // horizontal shifts
constexpr int kHalo = kPW / 2;           // 8

// ---- the fp32 forward ----
constexpr int kTX = 64;                  // output columns of a row tile
constexpr int kWin = kTX + kPW - 1;      // f2 columns a row tile reads (80)
constexpr int kXPT = 4;                  // output columns per thread
constexpr int kCG = 8;                   // lanes splitting a column group's channels
constexpr int kThreads = (kTX / kXPT) * kCG;  // 128
constexpr int kCS = 4 * kCG;             // channels a stage: one 16-byte quad a lane (32)
constexpr int kQuads = kCS / 4;          // quads of a staged column (8: 128 bytes)
constexpr int kStageQuads = (kTX + kWin) * kQuads;  // 1,152 quads (18,432 bytes)
constexpr int kStages = 4;               // stages of the ring
constexpr int kBlocksPerSM = 3;          // blocks the ring's shared memory lets an SM hold
constexpr size_t kFwdSmem = (size_t)kStages * kStageQuads * 16;  // 73,728 bytes
static_assert(kStageQuads % kThreads == 0, "a stage's copies split evenly over the threads");
static_assert(kTX * kPW * sizeof(float) <= kFwdSmem, "the output tile fits the ring");

// Stage the channels c0 .. c0+31 of a row tile into st: quad i is channels
// c0 + 4(i % 8) .. +3 of staged column i / 8, f1's column x0 + col for col <
// 64, else f2's column x0 - 8 + col - 64; zero outside [0, W) and past C.
// r1, r2 point at the row's column 0.
template <bool kVec>
__device__ __forceinline__ void fwd_stage(float4* __restrict__ st, const float* __restrict__ r1,
                                          const float* __restrict__ r2, int x0, int W, int C,
                                          int c0) {
#pragma unroll
  for (int k = 0; k < kStageQuads / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int col = i / kQuads, c = c0 + 4 * (i % kQuads);
    const bool one = col < kTX;
    const int x = one ? x0 + col : x0 - kHalo + (col - kTX);
    const bool in = x >= 0 && x < W && c < C;
    const float* src = (one ? r1 : r2) + (in ? (size_t)x * C + c : 0);
    if (kVec)
      cp_async16(st + i, src, in);
    else
      st[i] = in ? load4(src - c, c, C) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// grid (row tiles, H, B), kThreads threads, kFwdSmem bytes of dynamic
// shared memory.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
corr1d_fp32_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) float4 fwd_ring[];
  const int x0 = blockIdx.x * kTX;
  const size_t row = (size_t)blockIdx.z * H + blockIdx.y;
  const float* r1 = f1 + row * W * C;
  const float* r2 = f2 + row * W * C;
  const int nst = (C + kCS - 1) / kCS;
  const int q = threadIdx.x % kCG, xl = (threadIdx.x / kCG) * kXPT;

  float acc[kXPT][kPW];
#pragma unroll
  for (int i = 0; i < kXPT; ++i)
#pragma unroll
    for (int d = 0; d < kPW; ++d) acc[i][d] = 0.f;

  // stage j into buffer j % kStages; one cp.async group a stage, empty or not
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nst) fwd_stage<kVec>(fwd_ring + j * kStageQuads, r1, r2, x0, W, C, j * kCS);
    cp_async_commit();
  }
  for (int j = 0; j < nst; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage j are in
    __syncthreads();               // ... every thread's; stage j - 1 is read
    const int jn = j + kStages - 1;  // into stage j - 1's buffer
    if (jn < nst)
      fwd_stage<kVec>(fwd_ring + (jn % kStages) * kStageQuads, r1, r2, x0, W, C, jn * kCS);
    cp_async_commit();
    const float4* st = fwd_ring + (j % kStages) * kStageQuads;
    float4 a[kXPT];
#pragma unroll
    for (int i = 0; i < kXPT; ++i) a[i] = st[(xl + i) * kQuads + q];
    const float4* s2 = st + (kTX + xl) * kQuads + q;  // f2 window column xl + w at s2[8w]
#pragma unroll
    for (int w = 0; w < kXPT + kPW - 1; ++w) {
      const float4 v = s2[w * kQuads];
#pragma unroll
      for (int i = 0; i < kXPT; ++i) {
        const int d = w - i;  // the shift of column xl + i that meets it
        if (d < 0 || d >= kPW) continue;
        float t = acc[i][d];
        t = fmaf(a[i].x, v.x, t);
        t = fmaf(a[i].y, v.y, t);
        t = fmaf(a[i].z, v.z, t);
        acc[i][d] = fmaf(a[i].w, v.w, t);
      }
    }
  }

  // Sum over the kCG adjacent lanes that split this column group's channels.
#pragma unroll
  for (int i = 0; i < kXPT; ++i)
#pragma unroll
    for (int d = 0; d < kPW; ++d)
#pragma unroll
      for (int m = kCG / 2; m > 0; m >>= 1) acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], m);

  // The tile's sums, out[x0 + x, d] at tile[x * 17 + d], through the ring
  // (free once every warp is done with it): lane q writes every kCG-th of its
  // group's 4 x 17 sums; then the tile's outputs, one run of 17 x columns
  // floats in the output, go out by consecutive threads.
  __syncthreads();
  float* tile = reinterpret_cast<float*>(fwd_ring);
#pragma unroll
  for (int n = 0; n < kXPT * kPW; ++n)
    if (n % kCG == q) tile[xl * kPW + n] = acc[n / kPW][n % kPW];
  __syncthreads();
  float* o = out + (row * W + x0) * kPW;
  for (int i = threadIdx.x; i < min(kTX, W - x0) * kPW; i += kThreads) o[i] = tile[i];
}

inline int launch_fwd_fp32(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                           bool vec, cudaStream_t stream) {
  auto kernel = vec ? corr1d_fp32_kernel<true> : corr1d_fp32_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTX - 1) / kTX, H, B);
  kernel<<<grid, kThreads, kFwdSmem, stream>>>(static_cast<const float*>(f1),
                                               static_cast<const float*>(f2),
                                               static_cast<float*>(out), H, W, C);
  return (int)cudaGetLastError();
}

// ---- the fp32 backward tile ----
constexpr int kBX = 64;                   // output columns per block
constexpr int kBC = 64;                   // channels per block
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
