// Shared tile core of the matrix-engine kernels on Hopper (device code
// only): staging of a tile's A data and B slab with cp.async into a
// ring of kStages stages, a 3xTF32 tensor-core product of a dense A tile
// held in shared memory, a zero-skipping walk over the tile's nonzeros,
// and the every-entry FFMA products that B holding an Inf or NaN calls
// for.  dense_tile_spmm.cu and structured_spmm.cu include it.
//
// A block covers kRows output rows and kCols output columns with kThreads
// threads (8 warps), in one of two register layouts:
// - the tensor-core layout (MmaAcc): warp (wm, wn) = (warp / 2, warp % 2)
//   owns rows 32*wm + [0, 32) and columns 64*wn + [0, 64) as 2 x 8
//   m16n8 fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32;
// - the walk layout (WalkAcc): warp w owns rows 16*w + [0, 16), lane l
//   columns 4*l + [0, 4); every index is static, so nothing spills.
//
// The 3xTF32 product splits each fp32 operand x into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, in registers as the fragments are loaded)
// and sums lo*hi + hi*lo + hi*hi in fp32: about fp32 accuracy (the dropped
// lo*lo term is ~2^-22 relative), where plain TF32 keeps about three
// decimal digits.
//
// Non-finite input.  The reference multiplies every entry of a dense
// tile, so where B holds an Inf or NaN, 0 * Inf gives NaN and a stored
// nonzero times Inf gives +-Inf; where A holds one, it meets every B
// value of its row (+-Inf, or NaN against a 0).  Neither the zero-
// skipping walk (it never meets the zeros) nor the split product gives
// that: for x an Inf, a NaN or |x| >= 3.401993e38 (which cvt.rna rounds
// to Inf), lo = tf32(x - hi) is NaN, and setting lo = 0 would not do (the
// cross term lo(A) * hi(B) is 0 * Inf = NaN wherever A is exact in tf32,
// every 1.0 of an adjacency matrix).  So each call first runs
// nonfinite_kernel, which writes one flag per block of its grid (one read
// of B: a value the split cannot carry) and copies A's flag (computed from
// A's values when the plan is built, repro_torch.core.plan_ir.
// unsplittable_flag) after them, never read on the host; then two kernels
// read those flags (route_every_entry): the fast kernel returns at once
// where one is set, and every_entry_kernel returns at once where none is,
// and otherwise multiplies every entry of every tile in fp32 FFMAs
// (walk_all): IEEE products, the reference's answer.  The slow path lives
// in its own kernel so that the fast kernels keep their registers (on the
// H100, sharing one kernel cost B1's tensor-core path 4 % and the N:M slot
// walk 60 %, from one block per SM where two fitted), and it runs as a
// persistent grid of a few blocks per SM, so that its launch costs
// microseconds on finite input.
//
// The staged A slice is row-major with row stride kAStride (kSlice + 4:
// the fragment loads of one warp hit 32 distinct banks); the B slab is
// row-major with row stride kBStride (kCols + 8, likewise).  Cells that no
// copy writes (rows past the tile, columns past N, k past the slice's
// multiple of 8) are zero: a kernel zeroes its ring once and never writes
// them, or zeroes them explicitly where the slice width changes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_core {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;            // output rows per block
constexpr int kCols = 128;            // output columns per block
constexpr int kSlice = 64;            // deepest k-slice staged at once
constexpr int kAStride = kSlice + 4;  // floats per staged A row
constexpr int kBStride = kCols + 8;   // floats per staged B row
constexpr int kEStride = kCols + 4;   // floats per row of the epilogue tile
constexpr int kAFloats = kRows * kAStride;
constexpr int kBFloats = kSlice * kBStride;  // one B slab
constexpr int kWalkRows = kRows / kWarps;  // rows a warp walks (16)

// Tile density (nonzeros / staged cells) at or above which a tile runs the
// tensor-core product instead of the zero-skipping walk; set from the
// sweep in PERF.md (bench_torch/tile_path_sweep.py: on the H100 the walk
// of dense_tile_spmm wins up to about 4.6 %, the N:M walk up to 1:16).
constexpr float kMmaMinDensity = 0.05f;

using MmaAcc = float[2][8][4];
using WalkAcc = float[kWalkRows][4];

// ---- staging -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A ring of kStages stages: up to kStages - 1 tiles are in flight while one
// computes.
constexpr int kStages = 3;

// Wait for the stage about to compute in a ring of `stages` (1 to 3)
// stages, with stages - 1 groups allowed still in flight.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 3)
    cp_async_wait<2>();
  else if (stages == 2)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Start copying a rows x cols block of 4-byte words (source row stride
// src_ld) into shared memory (row stride dst_ld).  vec: 16-byte copies,
// for which cols, src_ld and dst_ld are multiples of 4 and src and dst
// are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, int dst_ld, const T* src,
                                            int64_t src_ld, int rows,
                                            int cols, bool vec) {
  static_assert(sizeof(T) == 4, "4-byte words");
  if (vec) {
    const int c4 = cols >> 2;
    if ((c4 & (c4 - 1)) == 0) {  // the usual widths: shifts, no division
      const int shift = __ffs(c4) - 1;
      for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
        const int r = i >> shift, c = (i & (c4 - 1)) << 2;
        cp_async16(dst + r * dst_ld + c, src + r * src_ld + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
        const int r = i / c4, c = (i - r * c4) << 2;
        cp_async16(dst + r * dst_ld + c, src + r * src_ld + c);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      cp_async4(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  }
}

// Words of misalignment of src within 16 bytes: stage_flat puts src[0] at
// dst + flat_shift(src), so that the bulk of the copy is 16-byte.
template <typename T>
__device__ __forceinline__ int flat_shift(const T* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
}

// Start copying count contiguous 4-byte words to dst + flat_shift(src)
// (dst 16-byte aligned, with room for count + 3 words).
template <typename T>
__device__ __forceinline__ void stage_flat(T* dst, const T* src, int count) {
  const int shift = flat_shift(src);
  T* d = dst + shift;
  const int head = min(count, (4 - shift) & 3);
  const int body = (count - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) cp_async4(d + i, src + i);
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(d + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < count; i += kThreads)
    cp_async4(d + i, src + i);
}

// Zero n floats at p (n a multiple of 4, p 16-byte aligned).
__device__ __forceinline__ void zero_smem(float* p, int n) {
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n / 4; i += kThreads)
    p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- the 3xTF32 tensor-core product --------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void zero(MmaAcc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ void zero(WalkAcc& acc) {
#pragma unroll
  for (int i = 0; i < kWalkRows; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc += A (kRows x 8*ksteps, stride kAStride) @ B
// (8*ksteps x kCols, stride kBStride), 3xTF32, both fp32 in shared memory
// and split into hi/lo in registers as their fragments are loaded.
// Fragment layouts (PTX ISA, m16n8k8 .tf32): a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); b0 (k=t, n=g), b1 (k=t+4, n=g); c0/c1
// (g, 2t/2t+1), c2/c3 (g+8, 2t/2t+1), with g = lane / 4, t = lane % 4.
//
// The tensor cores add into their fp32 accumulator without rounding to
// nearest, so a long chain of mma into one accumulator drifts (over the
// thousands of tiles of a Reddit-scale window, past 1e-4 of the result).
// Each call therefore sums its tile into fresh fragments, half of the
// n-fragments at a time, and adds them to acc with ordinary fp32 adds.
__device__ __forceinline__ void mma_tile(MmaAcc& acc, const float* a_s,
                                         const float* b_s, int ksteps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a_s + (32 * (warp >> 1) + g) * kAStride + t;
  const float* b0 = b_s + t * kBStride + 64 * (warp & 1) + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][nj][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k = 8 * ks;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = a0 + 16 * mi * kAStride + k;
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8 * kAStride], ah[mi][1], al[mi][1]);
        split_tf32(p[4], ah[mi][2], al[mi][2]);
        split_tf32(p[8 * kAStride + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const float* q = b0 + k * kBStride + 8 * (4 * half + nj);
        uint32_t bh[2], bl[2];
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[4 * kBStride], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(part[mi][nj], al[mi], bh);
          mma_tf32(part[mi][nj], ah[mi], bl);
          mma_tf32(part[mi][nj], ah[mi], bh);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][4 * half + nj][e] += part[mi][nj][e];
  }
}

// Write the tensor-core accumulators to a kRows x kCols tile e (row stride
// kEStride) in shared memory.
__device__ __forceinline__ void store_mma(const MmaAcc& acc, float* e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* base = e + (32 * (warp >> 1) + g) * kEStride + 64 * (warp & 1) +
                2 * t;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float* p = base + 16 * mi * kEStride + 8 * ni;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][0],
                                                  acc[mi][ni][1]);
      *reinterpret_cast<float2*>(p + 8 * kEStride) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---- the zero-skipping walk ----------------------------------------------

// acc_row[0..3] += v * b_row[4*lane .. 4*lane+3]: one float4 of the B slab
// row (a warp reads 512 contiguous bytes) and four FFMAs.
__device__ __forceinline__ void fma_row(float (&acc_row)[4], float v,
                                        const float* b_row) {
  const float4 bv =
      *reinterpret_cast<const float4*>(b_row + 4 * (threadIdx.x & 31));
  acc_row[0] = fmaf(v, bv.x, acc_row[0]);
  acc_row[1] = fmaf(v, bv.y, acc_row[1]);
  acc_row[2] = fmaf(v, bv.z, acc_row[2]);
  acc_row[3] = fmaf(v, bv.w, acc_row[3]);
}

// Occupancy of the staged A slice (width <= kSlice columns): lane i < 16
// of warp w gets in occ the nonzero mask of row 16*w + i (bit c for column
// c), built by warp ballots; returns the warp's nonzero count in every
// lane.  NaN counts as nonzero.
__device__ __forceinline__ int occupancy(const float* a_s, int width,
                                         uint64_t& occ) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  occ = 0u;
  int count = 0;
#pragma unroll
  for (int i = 0; i < kWalkRows; ++i) {
    const float* row = a_s + (kWalkRows * warp + i) * kAStride;
    const uint32_t m0 = __ballot_sync(~0u, lane < width && row[lane] != 0.f);
    const uint32_t m1 =
        __ballot_sync(~0u, lane + 32 < width && row[lane + 32] != 0.f);
    if (lane == i) occ = (static_cast<uint64_t>(m1) << 32) | m0;
    count += __popc(m0) + __popc(m1);
  }
  return count;
}

// acc += the staged A slice (masks from occupancy) @ B slab, one B slab row
// and four FFMAs a lane per nonzero; rows i and i + 8 are walked together
// for two independent chains of loads.  Zeros are skipped, which is exact
// for finite B only: where B holds an Inf or NaN, every_entry_kernel runs
// instead (see route_every_entry).
__device__ __forceinline__ void walk_tile(WalkAcc& acc, const float* a_s,
                                          const float* b_s, uint64_t occ) {
  const int warp = threadIdx.x >> 5;
  const float* rows = a_s + kWalkRows * warp * kAStride;
#pragma unroll
  for (int i = 0; i < kWalkRows / 2; ++i) {
    const int j = i + kWalkRows / 2;
    uint64_t mi = __shfl_sync(~0u, occ, i);
    uint64_t mj = __shfl_sync(~0u, occ, j);
    while (mi | mj) {
      if (mi) {
        const int c = __ffsll(mi) - 1;
        mi &= mi - 1u;
        fma_row(acc[i], rows[i * kAStride + c], b_s + c * kBStride);
      }
      if (mj) {
        const int c = __ffsll(mj) - 1;
        mj &= mj - 1u;
        fma_row(acc[j], rows[j * kAStride + c], b_s + c * kBStride);
      }
    }
  }
}

// ---- epilogue ------------------------------------------------------------

// Write rows [0, rows) x columns [0, cols) of the block's tile to dst
// (row stride ld, dst at the tile's first element): row 16*warp + i,
// columns 4*lane + [0, 4) hold walk[i] plus, when e is given, the same
// cells of the shared-memory tile e.  vec: float4 stores (ld a multiple of
// 4, dst 16-byte aligned).
__device__ __forceinline__ void write_tile(float* dst, int64_t ld, int rows,
                                           int cols, bool vec,
                                           const WalkAcc& walk,
                                           const float* e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 4 * lane;
#pragma unroll
  for (int i = 0; i < kWalkRows; ++i) {
    const int r = kWalkRows * warp + i;
    if (r >= rows || c >= cols) continue;
    float v[4] = {walk[i][0], walk[i][1], walk[i][2], walk[i][3]};
    if (e != nullptr) {
      const float4 ev = *reinterpret_cast<const float4*>(e + r * kEStride + c);
      v[0] += ev.x;
      v[1] += ev.y;
      v[2] += ev.z;
      v[3] += ev.w;
    }
    float* p = dst + r * ld + c;
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < cols) p[j] = v[j];
    }
  }
}

// ---- every entry: the path for non-finite input ----------------------------

// Blocks of nonfinite_kernel, hence flags of B a call writes; A's flag
// follows them, so the wrappers allocate kFlagInts ints
// (kernels/dense_tile_spmm.py NONFINITE_FLAGS).
constexpr int kFlagBlocks = 512;
constexpr int kFlagInts = kFlagBlocks + 1;

// |x| as bits from which the split cannot carry x: 0x7f7ff000 is
// 3.401993e38, which cvt.rna.tf32 rounds to Inf; Inf and NaN lie above it
// (repro_torch.core.plan_ir.TF32_SPLIT_LIMIT_BITS).
constexpr uint32_t kSplitLimitBits = 0x7f7ff000u;

__device__ __forceinline__ bool splittable(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) < kSplitLimitBits;
}

__device__ __forceinline__ bool splittable4(float4 x) {
  return splittable(x.x) && splittable(x.y) && splittable(x.z) &&
         splittable(x.w);
}

// flags[blockIdx.x] = 1 where this block's grid-stride share of the `count`
// floats of b holds a value the split cannot carry (an Inf, a NaN or
// |x| >= 3.401993e38), else 0: one read of b, 16-byte loads where b is
// aligned, four in flight a thread.  Block 0 also copies A's flag *a_flag
// to flags[kFlagBlocks].  Launched with kFlagBlocks blocks of kThreads.
__global__ void __launch_bounds__(kThreads)
nonfinite_kernel(const float* __restrict__ b, int64_t count,
                 const int* __restrict__ a_flag, int* __restrict__ flags) {
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[kFlagBlocks] = *a_flag;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  bool ok = true;
  int64_t tail = 0;
  if (aligned16(b)) {
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int64_t n4 = count / 4;
    int64_t i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {
      const float4 x0 = __ldg(b4 + i), x1 = __ldg(b4 + i + stride);
      const float4 x2 = __ldg(b4 + i + 2 * stride);
      const float4 x3 = __ldg(b4 + i + 3 * stride);
      ok = ok && splittable4(x0) && splittable4(x1) && splittable4(x2) &&
           splittable4(x3);
    }
    for (; i < n4; i += stride) ok = ok && splittable4(__ldg(b4 + i));
    tail = 4 * n4;
  }
  for (int64_t j = tail + tid; j < count; j += stride)
    ok = ok && splittable(__ldg(b + j));
  const int bad = __syncthreads_or(!ok);
  if (threadIdx.x == 0) flags[blockIdx.x] = bad != 0;
}

// True where A or B holds a value the split cannot carry: any of the
// kFlagInts flags nonfinite_kernel wrote (the launch before this one on
// the stream) set.  Every thread of the block must call it (a block-wide
// OR); uniform across the grid.
__device__ __forceinline__ bool route_every_entry(const int* flags) {
  int bad = 0;
  for (int i = threadIdx.x; i < kFlagInts; i += blockDim.x)
    bad |= __ldg(flags + i);
  return __syncthreads_or(bad) != 0;
}

// acc += the staged A slice (width columns) @ B slab in the walk layout,
// every entry multiplied, zeros included: fp32 FFMAs, so 0 * Inf = NaN as
// in the reference's dense product.
__device__ __forceinline__ void walk_all(WalkAcc& acc, const float* a_s,
                                         const float* b_s, int width) {
  const float* rows = a_s + kWalkRows * (threadIdx.x >> 5) * kAStride;
  for (int c = 0; c < width; ++c) {
    const float4 bv = *reinterpret_cast<const float4*>(
        b_s + c * kBStride + 4 * (threadIdx.x & 31));
#pragma unroll
    for (int i = 0; i < kWalkRows; ++i) {
      const float v = rows[i * kAStride + c];
      acc[i][0] = fmaf(v, bv.x, acc[i][0]);
      acc[i][1] = fmaf(v, bv.y, acc[i][1]);
      acc[i][2] = fmaf(v, bv.z, acc[i][2]);
      acc[i][3] = fmaf(v, bv.w, acc[i][3]);
    }
  }
}

// ---- launch helpers and the every-entry kernel ----------------------------

// The most dynamic shared memory a block may opt in to on this device.
inline cudaError_t smem_optin(size_t& bytes) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  bytes = static_cast<size_t>(max_optin);
  return err;
}

// Raise the dynamic shared-memory limit of `kernel` to `bytes` (past the
// default 48 KB only by opting in); cudaErrorInvalidValue past the card's
// per-block maximum.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  size_t max_optin = 0;
  cudaError_t err = smem_optin(max_optin);
  if (err != cudaSuccess) return err;
  if (bytes > max_optin) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Where A or B holds a value the split cannot carry (else every block
// returns at once): the
// packed (num_windows*bm, n) product with every tile entry multiplied.
// Cells is the payload's decoder: cells.cell(row, c) is the dense value of
// tile row `row` (t*bm + r, 64-bit) at column c < bk, as the reference
// expands it.  The work is the fast kernel's: one unit per (segment, 128-
// column n-tile, 128-row chunk), a segment being a window's
// [seg[w], seg[w+1]) of order (chunks == nullptr; written to out) or a
// chunk (window, first, end, slot) of dense_tile_spmm (written to out or to
// partial slot `slot`).  A persistent grid walks the units; per tile and
// 64-deep k-slice the block fills the dense slice and the B slab with
// plain loads, then walk_all.  Slow, and only for input the result of
// which is NaN or +-Inf somewhere.
template <class Cells>
__global__ void __launch_bounds__(kThreads)
every_entry_kernel(Cells cells, const int* __restrict__ order,
                   const int* __restrict__ seg,
                   const int4* __restrict__ chunks,
                   const int* __restrict__ step_col,
                   const float* __restrict__ b,
                   const int* __restrict__ flags,
                   float* __restrict__ out, float* __restrict__ partial,
                   int n_segments, int bm, int bk, int n) {
  if (!route_every_entry(flags)) return;
  extern __shared__ float4 smem4[];
  float* const a_s = reinterpret_cast<float*>(smem4);
  float* const b_s = a_s + kAFloats;
  const int n_tiles = (n + kCols - 1) / kCols;
  const int row_chunks = (bm + kRows - 1) / kRows;
  const int n_slices = (bk + kSlice - 1) / kSlice;
  const int64_t units =
      static_cast<int64_t>(n_segments) * n_tiles * row_chunks;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int sgm = static_cast<int>(u / (n_tiles * row_chunks));
    const int n0 = static_cast<int>((u / row_chunks) % n_tiles) * kCols;
    const int r0 = static_cast<int>(u % row_chunks) * kRows;
    const int rows = min(kRows, bm - r0), cols = min(kCols, n - n0);
    int first, end;
    float* dst;
    if (chunks != nullptr) {
      const int4 ch = chunks[sgm];
      first = ch.y;
      end = ch.z;
      dst = ch.w < 0 ? out + (static_cast<int64_t>(ch.x) * bm + r0) * n + n0
                     : partial + (static_cast<int64_t>(ch.w) * bm + r0) * n +
                           n0;
    } else {
      first = seg[sgm];
      end = seg[sgm + 1];
      dst = out + (static_cast<int64_t>(sgm) * bm + r0) * n + n0;
    }
    WalkAcc acc;
    zero(acc);
    for (int s = first; s < end; ++s) {
      const int t = order[s];
      const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
      const float* b_blk = b + static_cast<int64_t>(step_col[t]) * bk * n;
      for (int sl = 0; sl < n_slices; ++sl) {
        const int k0 = sl * kSlice, width = min(kSlice, bk - k0);
        __syncthreads();  // the last product has read a_s and b_s
        for (int i = threadIdx.x; i < kRows * kSlice; i += kThreads) {
          const int r = i / kSlice, c = i % kSlice;
          a_s[r * kAStride + c] =
              r < rows && c < width ? cells.cell(row0 + r, k0 + c) : 0.f;
        }
        for (int i = threadIdx.x; i < kSlice * kCols; i += kThreads) {
          const int k = i / kCols, c = i % kCols;
          b_s[k * kBStride + c] =
              k < width && c < cols
                  ? b_blk[static_cast<int64_t>(k0 + k) * n + n0 + c]
                  : 0.f;
        }
        __syncthreads();
        walk_all(acc, a_s, b_s, width);
      }
    }
    write_tile(dst, n, rows, cols, (n & 3) == 0, acc, nullptr);
  }
}

// Launch nonfinite_kernel on `stream`: kFlagBlocks flags for the count
// floats of b (contiguous), then A's flag *a_flag, in kFlagInts ints.
inline cudaError_t launch_nonfinite(const float* b, int64_t count,
                                    const int* a_flag, int* flags,
                                    cudaStream_t stream) {
  nonfinite_kernel<<<kFlagBlocks, kThreads, 0, stream>>>(b, count, a_flag,
                                                         flags);
  return cudaGetLastError();
}

// Launch every_entry_kernel on `stream` over n_segments segments (seg) or
// chunks (chunks): a persistent grid of at most two blocks per SM.
template <class Cells>
cudaError_t launch_every_entry(const Cells& cells, const int* order,
                               const int* seg, const int4* chunks,
                               const int* step_col, const float* b,
                               const int* flags, float* out, float* partial,
                               int n_segments, int bm, int bk, int n,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kAFloats + kBFloats);
  cudaError_t err = allow_smem(every_entry_kernel<Cells>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t units = static_cast<int64_t>(n_segments) *
                        ((n + kCols - 1) / kCols) * ((bm + kRows - 1) / kRows);
  if (units == 0) return cudaSuccess;
  const int grid = static_cast<int>(units < 2 * sms ? units : 2 * sms);
  every_entry_kernel<Cells><<<grid, kThreads, smem, stream>>>(
      cells, order, seg, chunks, step_col, b, flags, out, partial,
      n_segments, bm, bk, n);
  return cudaGetLastError();
}

}  // namespace tile_core
