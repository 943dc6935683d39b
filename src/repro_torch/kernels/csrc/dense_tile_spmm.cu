// Matrix-engine path of NeutronSparse on Hopper: SpMM over the flat
// active-tile stream.
//
// Replaces: the Pallas TPU kernel repro/kernels/dense_tile_spmm.py
// (dense_tile_spmm), which walks the stream tile by tile on a sequential
// grid and keeps one fp32 (bm, bn) output block resident in VMEM while a
// window's consecutive tiles accumulate into it.
//
// Computes: for every active tile t,
//   out[w[t]*bm : +bm, :] += flat_values[t] (bm x bk) @ B[c[t]*bk : +bk, :]
// in fp32 (FFMA, no TF32), returning the packed (num_windows*bm, N) output.
// A window with no tiles comes out as zeros.
//
// What bounds it on the H100: as written, each tile element meets N
// columns of B, so at the main path's N = 256 the kernel does 512 flops per
// 4-byte A element read once: ~128 flops/byte, far above the card's fp32
// ridge (67 TFLOP/s / 3.35 TB/s = 20 flops/byte), so this kernel is bound
// by fp32 operations.  The product itself needs a multiply-add only per
// nonzero; where the tiles are mostly zeros (they are at Reddit scale, see
// PERF.md) its least time is the read of the tile stream, bytes.  Closing
// that gap means skipping zeros or moving the core/fringe split, not a
// faster dense loop.
//
// Design: blocks run in any order on the GPU, so the TPU's "reset at each
// window change" becomes a segment walk.  The wrapper sorts tile indices
// by window (stable, on the device) and passes each window's segment
// [seg[w], seg[w+1]); one block per (window, 64-column n-tile,
// 128-row chunk) walks its window's segment and keeps the 128x64 output
// tile in registers (8x4 per thread) across the whole segment, writing it
// once, so no two blocks touch the same output and no atomics are needed.
// Each step stages a 32-deep slice of the A tile (transposed) and of the B
// block in shared memory and runs an outer-product FFMA loop.  The n-tile
// is 64 wide rather than the plan's 256, so that the Reddit-scale plan's
// 49 windows give 196 blocks instead of 49 for the 132 SMs; the n-tiles of
// one window are adjacent in the grid, so they stream the same A tiles
// through L2 at about the same time.  Offsets into flat_values and B are
// 64-bit: the stream can exceed 2^31 elements.  Simple and right first:
// no tensor cores, no cp.async/TMA pipelining yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 128;  // output rows per block (16 x TM)
constexpr int kColsPerBlock = 64;   // output columns per block (16 x TN)
constexpr int kDepth = 32;          // k-slice staged per step
constexpr int kTM = 8;              // rows per thread
constexpr int kTN = 4;              // columns per thread

__global__ void __launch_bounds__(kThreads)
dense_tile_spmm_kernel(const int* __restrict__ order,
                       const int* __restrict__ seg,
                       const int* __restrict__ step_col,
                       const float* __restrict__ flat_values,
                       const float* __restrict__ b,
                       float* __restrict__ out,
                       int n_tiles, int bm, int bk, int n) {
  // A slice stored transposed (k-major) with one pad column, so the
  // transposing stores hit distinct banks
  __shared__ float a_s[kDepth][kRowsPerBlock + 1];
  __shared__ float b_s[kDepth][kColsPerBlock];

  const int w = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * kColsPerBlock;
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx + 16*j
  const int ty = tid / 16;  // rows ty + 16*i

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int64_t tile_elems = static_cast<int64_t>(bm) * bk;
  const int s_end = seg[w + 1];
  for (int s = seg[w]; s < s_end; ++s) {
    const int t = order[s];
    const float* a = flat_values + static_cast<int64_t>(t) * tile_elems;
    const int64_t b_row0 = static_cast<int64_t>(step_col[t]) * bk;
    for (int k0 = 0; k0 < bk; k0 += kDepth) {
      // A: consecutive threads read consecutive k of one row (coalesced)
      for (int i = tid; i < kRowsPerBlock * kDepth; i += kThreads) {
        const int mm = i / kDepth, kk = i % kDepth;
        const int r = r0 + mm, kx = k0 + kk;
        a_s[kk][mm] = (r < bm && kx < bk)
                          ? a[static_cast<int64_t>(r) * bk + kx] : 0.f;
      }
      // B: consecutive threads read consecutive columns of one row
      for (int i = tid; i < kDepth * kColsPerBlock; i += kThreads) {
        const int kk = i / kColsPerBlock, nn = i % kColsPerBlock;
        const int kx = k0 + kk, c = n0 + nn;
        b_s[kk][nn] = (kx < bk && c < n)
                          ? b[(b_row0 + kx) * n + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float av[kTM], bv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int64_t out_row0 = static_cast<int64_t>(w) * bm;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= bm) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) out[(out_row0 + r) * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// order: (T,) tile indices sorted by window; seg: (num_windows+1,) segment
// offsets into order; step_col: (T,); flat_values: (T, bm, bk);
// b: (K, n) row-major; out: (num_windows*bm, n), every element written.
extern "C" int dense_tile_spmm_launch(const int* order, const int* seg,
                                      const int* step_col,
                                      const float* flat_values,
                                      const float* b, float* out,
                                      int num_windows, int bm, int bk, int n,
                                      void* stream) {
  if (num_windows == 0 || n == 0) return 0;
  const int n_tiles = (n + kColsPerBlock - 1) / kColsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + kRowsPerBlock - 1) / kRowsPerBlock);
  dense_tile_spmm_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      order, seg, step_col, flat_values, b, out, n_tiles, bm, bk, n);
  return static_cast<int>(cudaGetLastError());
}
