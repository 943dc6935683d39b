// SDDMM of NeutronSparse on Hopper: (X @ Y) sampled at a plan's nonzeros,
// on the same two paths as the SpMM.
//
// Replaces: the two Pallas TPU kernels of repro/kernels/sddmm.py,
//   - dense_tile_sddmm (matrix path): for every active (window, k-block)
//     tile t of the plan's stream,
//       tiles[t] = Xp[w[t]*bm : +bm, :] @ Yp[:, c[t]*bk : +bk]
//     on a sequential grid with the X row panel and the Y column slab in
//     VMEM, returning the fp32 stream (T, bm, bk);
//   - gather_sddmm (vector path): out[i] = X[rows[i]] . Yt[cols[i]] for
//     every fringe nonzero, in input order, with both dense panels resident
//     in VMEM and one dot per lane of a 128-lane output row.
//
// What bounds them on the H100:
//   - dense_tile_sddmm must write the whole tile stream (4*bm*bk bytes a
//     tile) and, as the reference defines it, multiplies every tile entry:
//     2*D flops per output element.  At D = 256 that is 128 flops per byte
//     written, above the card's fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20
//     flops/byte), so the kernel as written is bound by fp32 operations.
//     The sampled product needs a dot only per nonzero; where the tiles
//     are mostly zeros (2.5 % dense at Reddit scale, see PERF.md) its least
//     time is the write of the stream, bytes.
//   - gather_sddmm does 2*D flops per nonzero for two gathered D-wide rows
//     (8*D bytes): 0.25 flops/byte, bound by memory traffic.  The traffic
//     that counts is the rows fetched through the 50 MB L2 from device
//     memory, not the once-each input bytes.
//
// Design:
//   - dense_tile_sddmm: tiles are independent, so one block per (tile,
//     128-row chunk, 64-column chunk) stages a 32-deep slice of the X row
//     panel (transposed, one pad column against bank conflicts) and of the
//     Y column slab in shared memory and runs an outer-product FFMA loop
//     over D, 8x4 outputs a thread; each output is written once.  No
//     atomics and no window order: the result is deterministic.  The
//     reference's lane padding of D to 128 and rows to 8 is TPU layout and
//     is dropped: the kernel masks its ragged edges.  Offsets into Xp, Yp
//     and the stream are 64-bit (the stream can exceed 2^31 elements).
//   - gather_sddmm: one warp per nonzero reads both rows with coalesced
//     float4 loads (a scalar loop where D is not a multiple of 4 or a row
//     is not 16-byte aligned), each lane sums its elements in order and a
//     butterfly shuffle reduction in a fixed order finishes the dot; lane 0
//     writes it once.  The TPU's "both panels resident" premise does not
//     hold in 227 KB of shared memory and is not needed: rows come through
//     L2, so the panels have no size ceiling (the H100 SDDMM tier rule).
//   Simple and right first: no tensor cores, no cp.async/TMA yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 128;  // tile rows per block (16 x kTM)
constexpr int kColsPerBlock = 64;   // tile columns per block (16 x kTN)
constexpr int kDepth = 32;          // D-slice staged per step
constexpr int kTM = 8;              // rows per thread
constexpr int kTN = 4;              // columns per thread

__global__ void __launch_bounds__(kThreads)
dense_tile_sddmm_kernel(const int* __restrict__ step_window,
                        const int* __restrict__ step_col,
                        const float* __restrict__ xp,
                        const float* __restrict__ yp,
                        float* __restrict__ tiles,
                        int bm, int bk, int d, int64_t k) {
  __shared__ float x_s[kDepth][kRowsPerBlock + 1];
  __shared__ float y_s[kDepth][kColsPerBlock];

  const int64_t t = blockIdx.x;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int c0 = blockIdx.z * kColsPerBlock;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16*j
  const int ty = tid / 16;  // rows ty + 16*i
  const int64_t x_row0 = static_cast<int64_t>(step_window[t]) * bm;
  const int64_t y_col0 = static_cast<int64_t>(step_col[t]) * bk;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDepth) {
    // X: consecutive threads read consecutive d of one row (coalesced)
    for (int i = tid; i < kRowsPerBlock * kDepth; i += kThreads) {
      const int mm = i / kDepth, dd = i % kDepth;
      const int r = r0 + mm, dx = d0 + dd;
      x_s[dd][mm] = (r < bm && dx < d)
                        ? xp[(x_row0 + r) * d + dx] : 0.f;
    }
    // Y: consecutive threads read consecutive columns of one row of Yp
    for (int i = tid; i < kDepth * kColsPerBlock; i += kThreads) {
      const int dd = i / kColsPerBlock, nn = i % kColsPerBlock;
      const int dx = d0 + dd, c = c0 + nn;
      y_s[dd][nn] = (dx < d && c < bk)
                        ? yp[static_cast<int64_t>(dx) * k + y_col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kDepth; ++dd) {
      float xv[kTM], yv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) xv[i] = x_s[dd][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) yv[j] = y_s[dd][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = tiles + t * bm * bk;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < bk) out[static_cast<int64_t>(r) * bk + c] = acc[i][j];
    }
  }
}

constexpr int kWarps = 8;  // nonzeros per block, one per warp
constexpr unsigned kFull = 0xffffffffu;

template <bool kVec4>
__global__ void __launch_bounds__(32 * kWarps)
gather_sddmm_kernel(const int* __restrict__ rows,
                    const int* __restrict__ cols,
                    const float* __restrict__ x,
                    const float* __restrict__ yt,
                    float* __restrict__ out,
                    int64_t nnz, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps
                    + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= nnz) return;  // uniform across the warp
  const float* xr = x + static_cast<int64_t>(rows[i]) * d;
  const float* yr = yt + static_cast<int64_t>(cols[i]) * d;
  float acc = 0.f;
  if (kVec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (int q = lane; q < d / 4; q += 32) {
      const float4 a = x4[q];
      const float4 b = y4[q];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int q = lane; q < d; q += 32) acc = fmaf(xr[q], yr[q], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) out[i] = acc;
}

}  // namespace

// step_window, step_col: (T,); xp: (num_windows*bm, d) row-major; yp: (d, k)
// row-major, k a multiple of bk; tiles: (T, bm, bk), every element written.
extern "C" int dense_tile_sddmm_launch(const int* step_window,
                                       const int* step_col, const float* xp,
                                       const float* yp, float* tiles,
                                       int64_t num_tiles, int bm, int bk,
                                       int d, int64_t k, void* stream) {
  if (num_tiles == 0) return 0;
  const dim3 grid(static_cast<unsigned>(num_tiles),
                  (bm + kRowsPerBlock - 1) / kRowsPerBlock,
                  (bk + kColsPerBlock - 1) / kColsPerBlock);
  dense_tile_sddmm_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      step_window, step_col, xp, yp, tiles, bm, bk, d, k);
  return static_cast<int>(cudaGetLastError());
}

// rows, cols: (nnz,); x: (M, d) and yt: (K, d) row-major; out: (nnz,).
// vec4 != 0 asks for float4 loads: d a multiple of 4 and both panels
// 16-byte aligned.
extern "C" int gather_sddmm_launch(const int* rows, const int* cols,
                                   const float* x, const float* yt,
                                   float* out, int64_t nnz, int d, int vec4,
                                   void* stream) {
  if (nnz == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((nnz + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    gather_sddmm_kernel<true><<<blocks, 32 * kWarps, 0, s>>>(
        rows, cols, x, yt, out, nnz, d);
  else
    gather_sddmm_kernel<false><<<blocks, 32 * kWarps, 0, s>>>(
        rows, cols, x, yt, out, nnz, d);
  return static_cast<int>(cudaGetLastError());
}
