// Structured lane of the matrix-engine path on Hopper: SpMM over the flat
// active-tile stream when its tiles arrive packed, as N:M slots or as
// occupancy bitmaps.
//
// Replaces: the Pallas TPU kernels repro/kernels/structured_spmm.py
// (nm_tile_spmm and bitmap_tile_spmm).  Both walk the stream tile by tile
// on a sequential grid, re-expand each packed tile to a dense (bm, bk)
// block in VMEM and feed the MXU the same dense product as
// dense_tile_spmm, accumulating into one resident (bm, bn) output block per
// window.
//
// Computes: for every active tile t,
//   out[w[t]*bm : +bm, :] += A_t (bm x bk) @ B[c[t]*bk : +bk, :]
// in fp32, where A_t is given
// - N:M (nm_tile_spmm_launch): as slot-major values (bm, n*gk) and int32
//   codes (bm, gk), gk = bk/m: slot j of group g of a row holds the value
//   at in-group position (codes[g] >> 8j) & 0xFF.  Empty slots carry
//   (position 0, value 0.0) and add an exact 0; a position of m or more
//   selects no cell.
// - bitmap (bitmap_tile_spmm_launch): as occupancy words (bm, ceil(bk/32))
//   (column c at bit c%32 of word c/32; bit 31 is the int32 sign bit, so
//   the words are read as uint32) and the row's nonzeros packed in column
//   order (bm, row_cap): a set bit's value sits at its exclusive rank among
//   the row's set bits, clamped to row_cap - 1 as the reference clips.
// Returns the packed (num_windows*bm, N) output; a window with no tiles
// comes out as zeros.
//
// What bounds it on the H100: the product needs one multiply-add per
// nonzero and output column.  At the pruned-weight paths' shape (an
// 11,008 x 4,096 weight, N = 2,048) that is 9.2e10 flops at 2:4 and at 50 %
// unstructured (1.38 ms at 67 TFLOP/s fp32) and 5.8e9 at 1:32 (0.086 ms),
// against at most 0.29 GB of payload, B and output (0.09 ms at 3.35 TB/s):
// by operations.  At 1:32 each tile's 64 x N B slab must still cross L2
// into shared memory (2.9 GB at N = 2,048), which weighs more than the
// flops.
//
// nm_tile_spmm (on the tile core, tile_core.cuh): one block per (window,
// 128-column n-tile, 128-row chunk) walks its window's segment with a
// cp.async ring that stages the next tiles' payload rows and B slabs while
// the current tile computes (three stages where shared memory allows, else
// two; the next tiles' indices are loaded an iteration ahead), and writes
// its output tile once (no atomics, deterministic).  The path follows n/m,
// known on the host, as a template parameter:
// - n/m at or above the tile core's kMmaMinDensity (every pattern from
//   1:16 up, 2:4 and 4:16 among them): each tile
//   is decoded into a dense fp32 tile in shared memory, each cell the sum
//   in slot order of the slots that select it, starting from 0.0, as the
//   reference's _nm_expand adds (never assigns: an empty slot would erase a
//   real value at position 0), then the 3xTF32 tensor-core product runs
//   (mma.sync m16n8k8 .tf32; the first design fed every FFMA its own B
//   value from shared memory, 10 % of fp32 peak).
// - below it (1:32): the slot walk, one B slab row and four FFMAs a lane
//   per slot, each warp on 16 rows and the whole 128 columns, fed from the
//   ring (the first design staged each 16 KB slab with no overlap for 1/32
//   of the FFMAs).
// The sparse tensor cores (mma.sp) do not apply: for .tf32 operands the
// PTX ISA defines the sparse metadata at 1:2 granularity (one of each two
// consecutive tf32 elements kept), not 2:4, so fp32 2:4 weights have no
// sparse tensor-core form; 2:4 exists for 16-bit and 8-bit types only.
// Like dense_tile_spmm's walk, the N:M walk multiplies only the packed
// slots, so where B holds Inf or NaN it differs from the TPU kernel's dense
// product (and the 3xTF32 split turns an Inf of B into NaN).  bk is at most
// tile_core::kSlice (64), one staged slice.  Offsets are 64-bit.
//
// bitmap_tile_spmm (its first design, to move onto the tile core next):
// B1's first grid, one block per (window, 64-column n-tile, 128-row chunk);
// per tile the block stages the B slab and the payload rows in dynamic
// shared memory (rows padded by one word against bank conflicts), then each
// thread walks its rows' set bits with __ffs and a running rank: one
// shared-memory float4 and four FFMAs per nonzero.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 128;  // output rows per block (16 x TM)
constexpr int kColsPerBlock = 64;   // output columns per block (16 x TN)
constexpr int kTM = 8;              // rows per thread: ty + 16*i
constexpr int kTN = 4;              // adjacent columns per thread: 4*tx + j

// Stage B[b_row0 : +bk, n0 : +64] into b_s (bk x 64), zero past column n.
__device__ __forceinline__ void stage_b(float* b_s, const float* b,
                                        int64_t b_row0, int bk, int n,
                                        int n0) {
  for (int i = threadIdx.x; i < bk * kColsPerBlock; i += kThreads) {
    const int kk = i / kColsPerBlock, c = n0 + i % kColsPerBlock;
    b_s[i] = c < n ? b[(b_row0 + kk) * n + c] : 0.f;
  }
}

// Copy `rows` rows of `width` words from src (row stride width) into dst
// (row stride width + 1).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           int width) {
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, c = i % width;
    dst[r * (width + 1) + c] = src[i];
  }
}

__device__ __forceinline__ void fma4(float (&acc)[kTN], float v,
                                     const float* b_row, int tx) {
  const float4 bv = *reinterpret_cast<const float4*>(b_row + kTN * tx);
  acc[0] = fmaf(v, bv.x, acc[0]);
  acc[1] = fmaf(v, bv.y, acc[1]);
  acc[2] = fmaf(v, bv.z, acc[2]);
  acc[3] = fmaf(v, bv.w, acc[3]);
}

__device__ __forceinline__ void write_out(const float (&acc)[kTM][kTN],
                                          float* out, int w, int bm, int r0,
                                          int n, int n0, int tx, int ty) {
  const int64_t out_row0 = static_cast<int64_t>(w) * bm + r0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
    if (r0 + r >= bm) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + kTN * tx + j;
      if (c < n) out[(out_row0 + r) * n + c] = acc[i][j];
    }
  }
}

namespace tc = tile_core;

// Decode the staged N:M payload (values v, codes c of `rows` rows) into the
// dense fp32 tile a_s: cell (r, g*m + x) = sum over slots j in order of
// (pos_j == x ? v_j : 0), from 0.0, as the reference's _nm_expand adds
// (an empty slot, position 0 and value 0.0, must not erase a real value
// there; a position of m or more selects no cell).
template <int NPAT>
__device__ __forceinline__ void nm_decode(float* a_s, const float* v,
                                          const uint32_t* c, int rows,
                                          int gk, int m) {
  const int q = NPAT * gk;
  for (int idx = threadIdx.x; idx < rows * gk; idx += tc::kThreads) {
    const int r = idx / gk, g = idx - r * gk;
    const uint32_t code = c[idx];
    int pos[NPAT];
    float val[NPAT];
#pragma unroll
    for (int j = 0; j < NPAT; ++j) {
      pos[j] = (code >> (8 * j)) & 0xFF;
      val[j] = v[r * q + j * gk + g];
    }
    float* dst = a_s + r * tc::kAStride + g * m;
    for (int x = 0; x < m; ++x) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NPAT; ++j) sum += pos[j] == x ? val[j] : 0.f;
      dst[x] = sum;
    }
  }
}

// acc += the staged N:M payload @ B slab, slot by slot: warp w walks rows
// 16*w + i, one B slab row and four FFMAs a lane per slot; the 16 rows of a
// group index are independent, so their loads overlap.
template <int NPAT>
__device__ __forceinline__ void nm_walk(tc::WalkAcc& acc, const float* v,
                                        const uint32_t* c, const float* b_s,
                                        int rows, int gk, int m) {
  const int q = NPAT * gk;
  const int r0 = tc::kWalkRows * (threadIdx.x >> 5);
  for (int g = 0; g < gk; ++g) {
#pragma unroll
    for (int i = 0; i < tc::kWalkRows; ++i) {
      const int r = r0 + i;
      if (r >= rows) continue;
      const uint32_t code = c[r * gk + g];
#pragma unroll
      for (int j = 0; j < NPAT; ++j) {
        const int pos = (code >> (8 * j)) & 0xFF;
        if (pos < m)
          tc::fma_row(acc[i], v[r * q + j * gk + g],
                      b_s + (g * m + pos) * tc::kBStride);
      }
    }
  }
}

// Floats of one ring stage: the B slab, then the payload values and codes
// (each with room for the shift stage_flat applies, a multiple of 4).
__host__ __device__ inline int nm_values_words(int q) {
  return (tc::kRows * q + 4 + 3) & ~3;
}
__host__ __device__ inline int nm_stage_floats(int q, int gk) {
  return tc::kBFloats + nm_values_words(q) + ((tc::kRows * gk + 4 + 3) & ~3);
}

// Floats of shared memory: `stages` ring stages and, for the tensor cores,
// the decoded tile.
__host__ __device__ inline int nm_smem_floats(bool mma, int stages, int q,
                                              int gk) {
  return stages * nm_stage_floats(q, gk) + (mma ? tc::kAFloats : 0);
}

template <int NPAT, bool MMA>
__global__ void __launch_bounds__(tc::kThreads, 1)
nm_tile_spmm_kernel(const int* __restrict__ order,
                    const int* __restrict__ seg,
                    const int* __restrict__ step_col,
                    const float* __restrict__ nm_values,
                    const uint32_t* __restrict__ nm_codes,
                    const float* __restrict__ b,
                    float* __restrict__ out,
                    int n_tiles, int bm, int bk, int m_pat, int n,
                    int stages) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gk = bk / m_pat, q = NPAT * gk;
  // stage st at smem + st*stage: B slab, payload values, payload codes
  const int stage = nm_stage_floats(q, gk);
  const int v_off = tc::kBFloats, c_off = v_off + nm_values_words(q);
  float* const a_s = smem + stages * stage;  // the decoded tile (MMA only)

  const int w = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * tc::kCols;
  const int r0 = blockIdx.y * tc::kRows;
  const int rows = min(tc::kRows, bm - r0);
  const int cols = min(tc::kCols, n - n0);
  const bool vec_b = (n & 3) == 0 && tc::aligned16(b);

  // the cells no copy or decode writes stay zero
  tc::zero_smem(smem, nm_smem_floats(MMA, stages, q, gk));
  __syncthreads();

  // start staging tile t (B k-block col) into stage st
  auto fetch = [&](int st, int t, int col) {
    const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
    float* base = smem + st * stage;
    tc::stage_block(base, tc::kBStride,
                    b + static_cast<int64_t>(col) * bk * n + n0, n, bk,
                    cols, vec_b);
    tc::stage_flat(base + v_off, nm_values + row0 * q, rows * q);
    tc::stage_flat(reinterpret_cast<uint32_t*>(base + c_off),
                   nm_codes + row0 * gk, rows * gk);
  };

  typename std::conditional<MMA, tc::MmaAcc, tc::WalkAcc>::type acc;
  tc::zero(acc);

  // fill all stages but one; the tile and k-block of the next position to
  // stage, and the tile of the one after it, are loaded an iteration ahead
  const int s0 = seg[w], s1 = seg[w + 1];
  for (int i = 0; i < stages - 1; ++i) {
    if (s0 + i < s1) {
      const int t = order[s0 + i];
      fetch(i, t, step_col[t]);
    }
    tc::cp_async_commit();
  }
  int t_next = s0 + stages - 1 < s1 ? order[s0 + stages - 1] : 0;
  int c_next = s0 + stages - 1 < s1 ? step_col[t_next] : 0;
  int t_after = s0 + stages < s1 ? order[s0 + stages] : 0;
  for (int s = s0; s < s1; ++s) {
    const int st = (s - s0) % stages;
    const int ahead = s + stages - 1;
    if (ahead < s1) fetch((s - s0 + stages - 1) % stages, t_next, c_next);
    tc::cp_async_commit();
    const int t = order[s];
    t_next = t_after;
    c_next = ahead + 1 < s1 ? step_col[t_after] : 0;
    t_after = ahead + 2 < s1 ? order[ahead + 2] : 0;
    if (stages == 3)
      tc::cp_async_wait<2>();
    else
      tc::cp_async_wait<1>();
    __syncthreads();

    const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
    const float* base = smem + st * stage;
    const float* v = base + v_off + tc::flat_shift(nm_values + row0 * q);
    const uint32_t* c = reinterpret_cast<const uint32_t*>(base + c_off) +
                        tc::flat_shift(nm_codes + row0 * gk);
    if constexpr (MMA) {
      nm_decode<NPAT>(a_s, v, c, rows, gk, m_pat);
      __syncthreads();
      tc::mma_tile(acc, a_s, base, (bk + 7) >> 3);
    } else {
      nm_walk<NPAT>(acc, v, c, base, rows, gk, m_pat);
    }
    __syncthreads();  // a later iteration refills this stage
  }
  tc::cp_async_wait<0>();

  float* dst = out + (static_cast<int64_t>(w) * bm + r0) * n + n0;
  const bool vec_out = (n & 3) == 0;
  if constexpr (MMA) {
    tc::store_mma(acc, smem);
    __syncthreads();
    tc::WalkAcc none;
    tc::zero(none);
    tc::write_tile(dst, n, rows, cols, vec_out, none, smem);
  } else {
    tc::write_tile(dst, n, rows, cols, vec_out, acc, nullptr);
  }
}

__global__ void __launch_bounds__(kThreads)
bitmap_tile_spmm_kernel(const int* __restrict__ order,
                        const int* __restrict__ seg,
                        const int* __restrict__ step_col,
                        const uint32_t* __restrict__ words,
                        const float* __restrict__ values,
                        const float* __restrict__ b,
                        float* __restrict__ out,
                        int n_tiles, int bm, int bk, int n_words,
                        int row_cap, int n) {
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);
  float* v_s = b_s + bk * kColsPerBlock;
  uint32_t* w_s =
      reinterpret_cast<uint32_t*>(v_s + kRowsPerBlock * (row_cap + 1));
  // bits at or past column bk select nothing (the expansion reads only
  // columns below bk)
  const uint32_t last_mask =
      (bk % 32) ? ((1u << (bk % 32)) - 1u) : 0xFFFFFFFFu;

  const int w = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * kColsPerBlock;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int rows_here = min(kRowsPerBlock, bm - r0);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int s_end = seg[w + 1];
  for (int s = seg[w]; s < s_end; ++s) {
    const int t = order[s];
    const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
    stage_b(b_s, b, static_cast<int64_t>(step_col[t]) * bk, bk, n, n0);
    stage_rows(v_s, values + row0 * row_cap, rows_here, row_cap);
    stage_rows(w_s, words + row0 * n_words, rows_here, n_words);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows_here) continue;
      const float* vr = v_s + r * (row_cap + 1);
      const uint32_t* wr = w_s + r * (n_words + 1);
      int rank = 0;
      for (int wd = 0; wd < n_words; ++wd) {
        uint32_t bits = wr[wd];
        if (wd == n_words - 1) bits &= last_mask;
        while (bits) {
          const int c = wd * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          fma4(acc[i], vr[min(rank, row_cap - 1)],
               b_s + c * kColsPerBlock, tx);
          ++rank;
        }
      }
    }
    __syncthreads();
  }
  write_out(acc, out, w, bm, r0, n, n0, tx, ty);
}

template <int NPAT, bool MMA>
cudaError_t launch_nm(int num_windows, cudaStream_t stream, const int* order,
                      const int* seg, const int* step_col,
                      const float* nm_values, const uint32_t* nm_codes,
                      const float* b, float* out, int bm, int bk, int m_pat,
                      int n) {
  const int gk = bk / m_pat;
  // three ring stages where they fit in a block's shared memory, else two
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int stages = tc::kStages;
  while (stages > 2 &&
         sizeof(float) * nm_smem_floats(MMA, stages, NPAT * gk, gk) >
             static_cast<size_t>(max_optin))
    --stages;
  const size_t smem =
      sizeof(float) * nm_smem_floats(MMA, stages, NPAT * gk, gk);
  err = tc::allow_smem(nm_tile_spmm_kernel<NPAT, MMA>, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + tc::kCols - 1) / tc::kCols;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + tc::kRows - 1) / tc::kRows);
  nm_tile_spmm_kernel<NPAT, MMA><<<grid, tc::kThreads, smem, stream>>>(
      order, seg, step_col, nm_values, nm_codes, b, out, n_tiles, bm, bk,
      m_pat, n, stages);
  return cudaGetLastError();
}

template <int NPAT>
cudaError_t launch_nm_path(int num_windows, cudaStream_t stream,
                           const int* order, const int* seg,
                           const int* step_col, const float* nm_values,
                           const uint32_t* nm_codes, const float* b,
                           float* out, int bm, int bk, int m_pat, int n) {
  // n/m at or above the tile core's density threshold: decode + 3xTF32
  if (static_cast<float>(NPAT) >= tc::kMmaMinDensity * m_pat)
    return launch_nm<NPAT, true>(num_windows, stream, order, seg, step_col,
                                 nm_values, nm_codes, b, out, bm, bk, m_pat,
                                 n);
  return launch_nm<NPAT, false>(num_windows, stream, order, seg, step_col,
                                nm_values, nm_codes, b, out, bm, bk, m_pat,
                                n);
}

}  // namespace

// order: (T,) tile indices sorted by window; seg: (num_windows+1,) segment
// offsets into order; step_col: (T,); nm_values: (T, bm, n_pat*bk/m_pat);
// nm_codes: (T, bm, bk/m_pat); b: (K, n) row-major; out:
// (num_windows*bm, n), every element written.  1 <= n_pat <= 4, m_pat
// dividing bk and bk <= 64, else cudaErrorInvalidValue.
extern "C" int nm_tile_spmm_launch(const int* order, const int* seg,
                                   const int* step_col,
                                   const float* nm_values,
                                   const int* nm_codes, const float* b,
                                   float* out, int num_windows, int bm,
                                   int bk, int n, int n_pat, int m_pat,
                                   void* stream) {
  if (m_pat <= 0 || bk % m_pat || bk > tc::kSlice)
    return cudaErrorInvalidValue;
  if (num_windows == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* codes = reinterpret_cast<const uint32_t*>(nm_codes);
  cudaError_t err;
  switch (n_pat) {
    case 1:
      err = launch_nm_path<1>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, out, bm, bk, m_pat, n);
      break;
    case 2:
      err = launch_nm_path<2>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, out, bm, bk, m_pat, n);
      break;
    case 3:
      err = launch_nm_path<3>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, out, bm, bk, m_pat, n);
      break;
    case 4:
      err = launch_nm_path<4>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, out, bm, bk, m_pat, n);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// words: (T, bm, n_words) with n_words = ceil(bk/32); values:
// (T, bm, row_cap); the other arguments as for nm_tile_spmm_launch.
extern "C" int bitmap_tile_spmm_launch(const int* order, const int* seg,
                                       const int* step_col, const int* words,
                                       const float* values, const float* b,
                                       float* out, int num_windows, int bm,
                                       int bk, int n, int row_cap,
                                       void* stream) {
  const int n_words = (bk + 31) / 32;
  if (row_cap <= 0) return cudaErrorInvalidValue;
  if (num_windows == 0 || n == 0) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bk) * kColsPerBlock +
                       static_cast<size_t>(kRowsPerBlock) * (row_cap + 1) +
                       static_cast<size_t>(kRowsPerBlock) * (n_words + 1));
  cudaError_t err = tile_core::allow_smem(bitmap_tile_spmm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + kColsPerBlock - 1) / kColsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + kRowsPerBlock - 1) / kRowsPerBlock);
  bitmap_tile_spmm_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      order, seg, step_col, reinterpret_cast<const uint32_t*>(words), values,
      b, out, n_tiles, bm, bk, n_words, row_cap, n);
  return static_cast<int>(cudaGetLastError());
}
