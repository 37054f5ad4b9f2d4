// The bf16 band tile shared by the correlation kernels (corr1d.cu, corr2d.cu).
//
// Replaces, for bf16 inputs, the product loop of the TPU kernels
// pmt_learning_for_semantic_segmentation_and_disparity_tpu/ops/correlation.py:
// _corr1d_kernel and _corr2d_kernel. fp32 inputs keep corr_tile.cuh. corr1d's
// backward (corr1d.cu) runs its own transposed band over the same pieces: the
// tensor maps, the mbarrier ring, the swizzle and the fragment loads, plus the
// copy engine's stores below.
//
// One block owns kR f1 rows y0 .. y0+kR-1 of one image (NHWC) and a tile of
// kTX = 64 output columns x0 .. x0+63. For every f2 row r that one of its rows
// reaches (row y reaches r = y+i-ph/2, i in [0, ph)) it computes the band
//
//   out[y, x, 17*i + d] = sum_c f1[y, x, c] * f2[r, x + d - 8, c],  d in [0, 17),
//
// zero where x+d-8 or r falls outside the image. Products on the tensor cores
// (bf16 in, fp32 sums), stored as bf16.
//
// Bounds at the serving shape f1 = f2 = (16,64,120,352), and what the tile
// does about each (corr1d.cu and corr2d.cu give each kernel's figures):
// - device memory, the bound of both kernels: f1 and f2 are read about once
//   and the output written once; nothing is padded or widened in device
//   memory;
// - the copies from L2 into shared memory: f2's window is 80/64 of its 64
//   columns, and corr2d reads each window once per block of two rows;
// - shared-memory reads (ldmatrix) and tensor-core products: bf16 all the
//   way, 1.9x the useful products (below), far under the tensor cores' rate;
// - the hand-offs between the copy engine and the products: a ring, with
//   stages as wide as shared memory allows.
//
// Products. The band is a slice of a dense product: the 16 columns of an
// m-tile against the 32 f2 columns x-8 .. x+23 around them. Each of the 8
// consumer warps takes 16 output columns (g .. g+15 of the tile) and 2 of the
// 4 n-tiles of 8 f2 columns that cover them, for each of the block's f1 rows,
// with mma.sync.m16n8k16 (bf16, fp32 sums) fed by ldmatrix; one f2 fragment
// serves every f1 row. The accumulator (row m, column n) of n-tile t is shift
// d = 8t + n - m and is kept when d lies in [0, 17). That does 32/17 = 1.9x
// the useful products. wgmma was not taken: its 64-row M tile forces an
// 80-column window per m-tile, 4.7x the useful products.
//
// Staging: a ring of stages fed by the tensor memory accelerator. A 9th warp
// is the producer: for item j (one f2 row r and kb 64-channel boxes of it)
// it waits until the consumers have released stage j % ns (mbarrier
// "empty"), announces the bytes on the stage's "full" mbarrier and starts
// one 4-D tiled copy per box: 64 channels x 80 columns (the window with its
// 8-column halo each side) at (c0, x0-8, r, b). The copy engine zero-fills
// what lies outside the image or past C, so no halo or channel tail is
// handled in code, and writes each box in the 128-byte swizzle: 16-byte
// chunk q of box row n lands at chunk q ^ (n % 8), so the 8 rows of an
// ldmatrix phase hit 8 distinct bank groups. The consumers wait on "full",
// multiply, and arrive on "empty"; no block-wide barrier stands in the main
// loop. Every hand-off costs the consumers and the producer a wait, so the
// kernels take stages as wide as shared memory allows. f1's tile stays
// resident (its boxes arrive once, on their own mbarrier) or, for a C too
// large for shared memory, rides in each stage beside f2's boxes. Inputs the
// copy engine cannot take (C not a multiple of 8, or a pointer off 16-byte
// alignment: the tensor map's strides and base) are staged by the producer
// warp with element loads into the same swizzled layout, and the stage is
// released with a plain arrive. (The producer warp's 16-byte cp.async into
// the same layout, with no tensor map, measured 0.633 ms for corr2d and
// 0.085 ms for corr1d against the copy engine's 0.37 and 0.069: PERF.md.)
//
// Output. When an f2 row is done, each consumer warp stores its part of the
// band straight from the accumulators: for each of its 16 pixels, the
// outputs 17*i + d of the shifts d it holds. (Collecting the bands in a
// shared-memory tile for 16-byte stores measured 0.439 ms for corr2d against
// 0.37: its 74 KB leave room for fewer and narrower stages. PERF.md.)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace band {

using bf16 = __nv_bfloat16;

constexpr int kPW = 17;                   // horizontal shifts
constexpr int kTX = 64;                   // output columns per block
constexpr int kWin = kTX + kPW - 1;       // f2 columns a block needs (with halo)
constexpr int kCC = 64;                   // channels per box: 128 bytes, the swizzle span
constexpr int kConsumers = 8;             // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kF1Box = kTX * kCC * 2;     // bytes of one f1 box (8 KB)
constexpr int kF2Box = kWin * kCC * 2;    // bytes of one f2 box (10 KB)
constexpr int kSmemMax = 232448;          // dynamic shared memory per block, sm_90

// The layout a launch uses: ns stages of kb 64-channel boxes each, f1
// resident or staged per stage, and the dynamic shared memory it takes (1 KB
// of slack aligns the boxes to the swizzle's 1024 bytes).
struct Plan {
  int ns, kb;
  bool f1_res;
  size_t smem;
};

inline size_t smem_bytes(int R, int C, int ns, int kb, bool f1_res) {
  const int nb = (C + kCC - 1) / kCC;
  const size_t f1 = f1_res ? (size_t)R * nb * kF1Box : 0;
  const size_t stage = (size_t)kb * (kF2Box + (f1_res ? 0 : R * kF1Box));
  return 1024 + f1 + ns * stage + (2 * kMaxStages + 1) * 8;
}

// The widest stages (up to kb_max boxes) of which at least 2 fit in `budget`
// bytes, as many of them as fit (up to kMaxStages); f1 resident where it
// fits, else staged per stage. Every C has a plan: one-box stages with f1
// staged per stage take under 100 KB at 2 stages.
inline Plan plan(int C, int R, int kb_max, size_t budget) {
  const int nb = (C + kCC - 1) / kCC;
  for (int res = 1; res >= 0; --res) {
    for (int kb = kb_max < nb ? kb_max : nb; kb >= 1; --kb) {
      int ns = kMaxStages;
      while (ns > 2 && smem_bytes(R, C, ns, kb, res != 0) > budget) --ns;
      if (smem_bytes(R, C, ns, kb, res != 0) <= budget)
        return Plan{ns, kb, res != 0, smem_bytes(R, C, ns, kb, res != 0)};
    }
  }
  return Plan{2, 1, false, smem_bytes(R, C, 2, 1, false)};
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 4-D tiled map of one (B, H, W, C) bf16 tensor with boxes of `chans`
// channels (64 by default) x `cols` columns, swizzled by 128 bytes (or not at
// all), zero outside the tensor. The encoder, cuTensorMapEncodeTiled, is
// looked up in libcuda with dlopen, so nothing links to it.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int H, int W, int C,
                              int cols, int chans = kCC,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static const EncodeTiled encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)chans, (cuuint32_t)cols, 1, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copies from global to shared memory by cp.async (the fp32 kernels'
// rings): zero-filled, and nothing read, where !in (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Their element path: 4 channels c .. c+3 of one pixel (row points at its
// channel 0), zero past C.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int C) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  float* e = &v.x;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c + k < C) e[k] = row[c + k];
  return v;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive on bar, expecting `bytes` more from the copy engine before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete. A wait that never ends
// (a protocol fault) traps after 2^24 polls rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (n == (1u << 24)) __trap();
  }
}

// One box of a 4-D tiled map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c, int x, int y,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// One contiguous range of global memory into shared memory by the copy
// engine, completing on bar: both addresses 16-byte aligned, `bytes` a
// multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same four 8x8 matrices, each transposed: lane l gets rows 2(l%4) and
// 2(l%4)+1 of column l/4, which is a B fragment of mma.m16n8k16 when the rows
// in shared memory run along K (corr1d's backward: window columns).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Shared memory written by threads, made visible to the copy engine: each
// writing thread fences before the copy that reads it is issued.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of shared memory (in the map's layout) out to a 4-D tiled map at
// (c, x, y, b); the copy engine drops what lies outside the tensor. The copy
// joins the thread's open bulk group (bulk_commit closes it).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c, int x,
                                          int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of the thread's bulk groups are still writing.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of element (row n, channel c) of a box in the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int n, int c) {
  return n * 128 + ((((c >> 3) ^ n) & 7) << 4) + (c & 7) * 2;
}

// The producer warp's element copy of one box: columns [xb, xb + cols) x
// channels [c0, c0 + 64) of one image row, zero outside [0, W) x [0, C), in
// the layout the copy engine writes.
__device__ __forceinline__ void copy_box(unsigned char* dst, const bf16* __restrict__ row, int xb,
                                         int cols, int W, int C, int c0, int lane) {
  for (int k = lane; k < cols * kCC; k += 32) {
    const int n = k / kCC;
    const int c = k % kCC;
    const int x = xb + n;
    *reinterpret_cast<bf16*>(dst + swz(n, c)) =
        (x >= 0 && x < W && c0 + c < C) ? row[(size_t)x * C + c0 + c] : __float2bfloat16(0.f);
  }
}

// The block's tile. f1img, f2img: image b's (H, W, C) maps (tm1, tm2 the
// whole tensors' maps, read when kTma); out: image b's (H, W, 17*ph) output;
// rows y0 .. y0+kR-1 (those below H) against f2 rows y+i-ph/2, i in [0, ph),
// x in [x0, x0 + 64). smem: Plan::smem bytes for ns stages of kb boxes.
template <int kR, bool kTma>
__device__ __forceinline__ void band_tile(const CUtensorMap* tm1, const CUtensorMap* tm2,
                                          const bf16* __restrict__ f1img,
                                          const bf16* __restrict__ f2img, bf16* __restrict__ out,
                                          int b, int y0, int x0, int H, int W, int C, int ph,
                                          int ns, int kb, bool f1_res, unsigned char* smem_raw) {
  const int P = kPW * ph;
  const int hh = ph / 2;
  const int nb = (C + kCC - 1) / kCC;            // 64-channel boxes
  const int nq = (nb + kb - 1) / kb;             // stages of up to kb boxes per f2 row
  const int nr = min(kR, H - y0);                // f1 rows of this block
  const int r_lo = max(0, y0 - hh);              // f2 rows they reach
  const int r_hi = min(H, y0 + nr + hh);
  const int items = (r_hi - r_lo) * nq;          // (f2 row, channel chunk), >= 1
  const int stage = kb * (kF2Box + (f1_res ? 0 : kR * kF1Box));

  // [f1 boxes, if resident] [ns stages: kb f2 boxes (+ kR x kb f1 boxes)] [barriers]
  unsigned char* s1 = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* s2 = s1 + (f1_res ? kR * nb * kF1Box : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(s2 + (size_t)ns * stage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* f1bar = empty + kMaxStages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int ncols = min(kTX, W - x0);
  // outputs whose f2 row lies outside the image are zeros
  if (r_hi - r_lo < nr + 2 * hh) {
    for (int n = threadIdx.x; n < nr * ncols * P; n += kThreads) {
      const int a = n / (ncols * P);
      const int rem = n - a * ncols * P;
      const int r = y0 + a + (rem % P) / kPW - hh;
      if (r < 0 || r >= H) out[((size_t)(y0 + a) * W + x0) * P + rem] = __float2bfloat16(0.f);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(f1bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer ----
    // f1 rows a < nr, box kq, row a's at dst + a * a_stride, completing on bar
    auto f1_boxes = [&](unsigned char* dst, int a_stride, int kq, uint64_t* bar) {
      for (int a = 0; a < nr; ++a) {
        if (kTma) {
          if (lane == 0) tma_load(dst + a * a_stride, tm1, kq * kCC, x0, y0 + a, b, bar);
        } else {
          copy_box(dst + a * a_stride, f1img + (size_t)(y0 + a) * W * C, x0, kTX, W, C, kq * kCC,
                   lane);
        }
      }
    };
    if (f1_res) {
      if (kTma && lane == 0) mbar_expect_tx(f1bar, nr * nb * kF1Box);
      __syncwarp();
      for (int kq = 0; kq < nb; ++kq) f1_boxes(s1 + kq * kF1Box, nb * kF1Box, kq, f1bar);
      __syncwarp();
      if (!kTma && lane == 0) mbar_arrive(f1bar);
    }
    for (int j = 0; j < items; ++j) {
      const int s = j % ns;
      const int u = j / ns;
      if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);  // the consumers have released it
      const int r = r_lo + j / nq;
      const int q0 = (j % nq) * kb;                   // the stage's first box
      const int n = min(kb, nb - q0);
      unsigned char* st = s2 + (size_t)s * stage;
      if (kTma && lane == 0)
        mbar_expect_tx(&full[s], n * (kF2Box + (f1_res ? 0 : nr * kF1Box)));
      __syncwarp();
      for (int x = 0; x < n; ++x) {
        if (kTma) {
          if (lane == 0)
            tma_load(st + x * kF2Box, tm2, (q0 + x) * kCC, x0 - kPW / 2, r, b, &full[s]);
        } else {
          copy_box(st + x * kF2Box, f2img + (size_t)r * W * C, x0 - kPW / 2, kWin, W, C,
                   (q0 + x) * kCC, lane);
        }
        if (!f1_res) f1_boxes(st + kb * kF2Box + x * kF1Box, kb * kF1Box, q0 + x, &full[s]);
      }
      __syncwarp();
      if (!kTma && lane == 0) mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumers ----
    const int g = (warp & 3) * 16;             // the warp's 16 output columns
    const int half = warp >> 2;                // its n-tiles 2*half, 2*half+1
    // ldmatrix rows of this lane: A = f1 columns g + 0..15 (4 8x8 matrices:
    // rows 0-7 / 8-15 x k 0-7 / 8-15), B = f2 window columns g + 16*half +
    // 0..15 (n-tiles 2*half, 2*half+1 x k 0-7 / 8-15)
    const int am = g + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ka8 = (lane >> 4) * 8;
    const int bn = g + half * 16 + (lane >> 4) * 8 + (lane & 7);
    const int kb8 = ((lane >> 3) & 1) * 8;

    float acc[kR][2][4];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][t][e] = 0.f;

    if (f1_res) mbar_wait(f1bar, 0);
    for (int j = 0; j < items; ++j) {
      const int s = j % ns;
      mbar_wait(&full[s], (j / ns) & 1);
      const int r = r_lo + j / nq;
      const int q0 = (j % nq) * kb;
      const int n = min(kb, nb - q0);
      const uint32_t st = smem_u32(s2 + (size_t)s * stage);
      bool on[kR];  // f1 row a reaches f2 row r (uniform over the block)
      bool all_on = true;
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        on[a] = a < nr && r - (y0 + a) + hh >= 0 && r - (y0 + a) - hh <= 0;
        all_on = all_on && on[a];
      }
      // No `#pragma unroll N` on this loop: nvcc 12.9 unrolls it by N
      // with no remainder, so a stage of fewer than N boxes multiplies boxes
      // it does not hold (PERF.md §7).
      for (int x = 0; x < n; ++x) {
        const int kq = q0 + x;
        const uint32_t bx = st + x * kF2Box;
        // f1 row a's box kq: a0 + a * a_stride
        const uint32_t a0 = f1_res ? smem_u32(s1) + kq * kF1Box : st + kb * kF2Box + x * kF1Box;
        const int a_stride = f1_res ? nb * kF1Box : kb * kF1Box;
        const int ksteps = (min(kCC, C - kq * kCC) + 15) / 16;
        if (ksteps == kCC / 16 && all_on) {
          // the common case, without a branch: every fragment of the box
          // first, then its products
          uint32_t bfrag[kCC / 16][4], afrag[kCC / 16][kR][4];
#pragma unroll
          for (int ks = 0; ks < kCC / 16; ++ks) {
            ldmatrix_x4(bfrag[ks], bx + swz(bn, 16 * ks + kb8));
#pragma unroll
            for (int a = 0; a < kR; ++a)
              ldmatrix_x4(afrag[ks][a], a0 + a * a_stride + swz(am, 16 * ks + ka8));
          }
#pragma unroll
          for (int ks = 0; ks < kCC / 16; ++ks)
#pragma unroll
            for (int a = 0; a < kR; ++a) {
              mma_bf16(acc[a][0], afrag[ks][a], bfrag[ks][0], bfrag[ks][1]);
              mma_bf16(acc[a][1], afrag[ks][a], bfrag[ks][2], bfrag[ks][3]);
            }
        } else {
          for (int ks = 0; ks < ksteps; ++ks) {
            uint32_t bfrag[4];
            ldmatrix_x4(bfrag, bx + swz(bn, 16 * ks + kb8));
#pragma unroll
            for (int a = 0; a < kR; ++a) {
              if (!on[a]) continue;
              uint32_t afrag[4];
              ldmatrix_x4(afrag, a0 + a * a_stride + swz(am, 16 * ks + ka8));
              mma_bf16(acc[a][0], afrag, bfrag[0], bfrag[1]);
              mma_bf16(acc[a][1], afrag, bfrag[2], bfrag[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s
      if (q0 + n == nb) {  // f2 row r is done: its bands straight to the output
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          if (!on[a]) continue;
          const int i = r - (y0 + a) + hh;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // accumulator (m, n) of n-tile 2*half+t: pixel g + m, shift 8(2*half+t) + n - m
              const int m = (lane >> 2) + (e >> 1) * 8;
              const int d = 8 * (2 * half + t) + 2 * (lane & 3) + (e & 1) - m;
              if (d >= 0 && d < kPW && g + m < ncols)
                out[((size_t)(y0 + a) * W + x0 + g + m) * P + i * kPW + d] =
                    __float2bfloat16(acc[a][t][e]);
              acc[a][t][e] = 0.f;
            }
        }
      }
    }
  }
}

}  // namespace band
