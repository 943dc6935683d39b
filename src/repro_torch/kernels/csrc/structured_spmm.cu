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
// in fp32 (FFMA, no TF32), where A_t is given
// - N:M (nm_tile_spmm_launch): as slot-major values (bm, n*gk) and int32
//   codes (bm, gk), gk = bk/m: slot j of group g of a row holds the value
//   at in-group position (codes[g] >> 8j) & 0xFF.  Empty slots carry
//   (position 0, value 0.0) and add an exact 0.
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
// all three are bound by fp32 operations.
//
// Design: unlike the TPU kernels, these never expand a tile to dense, so
// they do n/m (N:M) or nnz/(bm*bk) (bitmap) of the dense multiply-adds.
// The grid follows dense_tile_spmm.cu: the wrapper sorts tile indices by
// window on the device and passes each window's segment; one block per
// (window, 64-column n-tile, 128-row chunk) walks its window's segment,
// keeps its 128 x 64 output tile in registers (8 rows x 4 adjacent columns
// a thread) and writes it once: no atomics, deterministic.  Per tile the
// block stages the B slab (bk x 64 fp32, 16 KB at bk = 64) and the tile's
// payload rows in dynamic shared memory (rows padded by one word so that
// the two rows a warp reads sit in different banks), then each thread
// walks its rows' nonzeros: decode the in-tile column, read four adjacent
// B values as one float4 (a quarter-warp reads 128 contiguous bytes, no
// bank conflict) and do four FFMAs.  Each FFMA thus needs its own B value
// from shared memory (different rows hit different B rows, so nothing is
// reused in registers): shared-memory bandwidth, not the FFMA rate, limits
// this design.  Offsets into the payloads, B and the output are 64-bit.
// Later work: tensor cores (wgmma on tiles re-expanded in shared memory),
// mma.sp for 2:4, the only pattern Hopper's sparse tensor cores take, and
// TMA/cp.async double-buffering of the B slab.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int NPAT>
__global__ void __launch_bounds__(kThreads)
nm_tile_spmm_kernel(const int* __restrict__ order,
                    const int* __restrict__ seg,
                    const int* __restrict__ step_col,
                    const float* __restrict__ nm_values,
                    const uint32_t* __restrict__ nm_codes,
                    const float* __restrict__ b,
                    float* __restrict__ out,
                    int n_tiles, int bm, int bk, int m_pat, int n) {
  extern __shared__ float4 smem4[];
  const int gk = bk / m_pat;
  const int q = NPAT * gk;
  float* b_s = reinterpret_cast<float*>(smem4);
  float* v_s = b_s + bk * kColsPerBlock;
  uint32_t* c_s = reinterpret_cast<uint32_t*>(v_s + kRowsPerBlock * (q + 1));

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
    stage_rows(v_s, nm_values + row0 * q, rows_here, q);
    stage_rows(c_s, nm_codes + row0 * gk, rows_here, gk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows_here) continue;
      const float* vr = v_s + r * (q + 1);
      const uint32_t* cr = c_s + r * (gk + 1);
      for (int g = 0; g < gk; ++g) {
        const uint32_t code = cr[g];
#pragma unroll
        for (int j = 0; j < NPAT; ++j) {
          const int pos = (code >> (8 * j)) & 0xFF;
          // a position outside the group selects no cell, as in the TPU
          // kernel's expansion
          if (pos < m_pat)
            fma4(acc[i], vr[j * gk + g],
                 b_s + (g * m_pat + pos) * kColsPerBlock, tx);
        }
      }
    }
    __syncthreads();
  }
  write_out(acc, out, w, bm, r0, n, n0, tx, ty);
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

// Set the dynamic shared-memory limit of `kernel` for `bytes` (above the
// default 48 KB only by opting in); cudaErrorInvalidValue past the card's
// per-block maximum.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(max_optin)) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int NPAT>
cudaError_t launch_nm(dim3 grid, cudaStream_t stream, const int* order,
                      const int* seg, const int* step_col,
                      const float* nm_values, const uint32_t* nm_codes,
                      const float* b, float* out, int n_tiles, int bm,
                      int bk, int m_pat, int n) {
  const int gk = bk / m_pat;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(bk) * kColsPerBlock +
                       static_cast<size_t>(kRowsPerBlock) * (NPAT * gk + 1) +
                       static_cast<size_t>(kRowsPerBlock) * (gk + 1));
  cudaError_t err = allow_smem(nm_tile_spmm_kernel<NPAT>, smem);
  if (err != cudaSuccess) return err;
  nm_tile_spmm_kernel<NPAT><<<grid, kThreads, smem, stream>>>(
      order, seg, step_col, nm_values, nm_codes, b, out, n_tiles, bm, bk,
      m_pat, n);
  return cudaGetLastError();
}

}  // namespace

// order: (T,) tile indices sorted by window; seg: (num_windows+1,) segment
// offsets into order; step_col: (T,); nm_values: (T, bm, n_pat*bk/m_pat);
// nm_codes: (T, bm, bk/m_pat); b: (K, n) row-major; out:
// (num_windows*bm, n), every element written.  1 <= n_pat <= 4 and m_pat
// dividing bk, else cudaErrorInvalidValue.
extern "C" int nm_tile_spmm_launch(const int* order, const int* seg,
                                   const int* step_col,
                                   const float* nm_values,
                                   const int* nm_codes, const float* b,
                                   float* out, int num_windows, int bm,
                                   int bk, int n, int n_pat, int m_pat,
                                   void* stream) {
  if (m_pat <= 0 || bk % m_pat) return cudaErrorInvalidValue;
  if (num_windows == 0 || n == 0) return 0;
  const int n_tiles = (n + kColsPerBlock - 1) / kColsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* codes = reinterpret_cast<const uint32_t*>(nm_codes);
  cudaError_t err;
  switch (n_pat) {
    case 1:
      err = launch_nm<1>(grid, st, order, seg, step_col, nm_values, codes, b,
                         out, n_tiles, bm, bk, m_pat, n);
      break;
    case 2:
      err = launch_nm<2>(grid, st, order, seg, step_col, nm_values, codes, b,
                         out, n_tiles, bm, bk, m_pat, n);
      break;
    case 3:
      err = launch_nm<3>(grid, st, order, seg, step_col, nm_values, codes, b,
                         out, n_tiles, bm, bk, m_pat, n);
      break;
    case 4:
      err = launch_nm<4>(grid, st, order, seg, step_col, nm_values, codes, b,
                         out, n_tiles, bm, bk, m_pat, n);
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
  cudaError_t err = allow_smem(bitmap_tile_spmm_kernel, smem);
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
