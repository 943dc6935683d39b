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
// in fp32, returning the packed (num_windows*bm, N) output.  A window with
// no tiles comes out as zeros.
//
// What bounds it on the H100: the product needs a multiply-add per nonzero
// and output column; the tiles must be read once.  On the Reddit-scale
// plan the tiles are 2.5 % dense (5.85 GB of tile stream for 1.84e10
// useful flops), so the least time is the read of the stream (bytes).  On
// pruned weights' general tiles (50 % dense) the flops weigh more.
//
// Design (tile core in tile_core.cuh):
// - Split segments.  The wrapper sorts tiles by window and cuts each
//   window's segment into chunks (window_chunks in dense_tile_spmm.py), so
//   that a plan of a few windows holding thousands of tiles each (49
//   windows of 3,641 tiles at Reddit scale) still gives several waves of
//   blocks over the 132 SMs.  One block per (chunk, 128-column n-tile,
//   128-row chunk) walks its chunk's tiles.  A window of one chunk is
//   written straight to out; a split window's chunks write partials to a
//   scratch buffer, and a second kernel (dense_tile_reduce_kernel) sums
//   them in chunk order and writes zeros for windows without tiles.  No
//   atomics: two calls are bit-identical.
// - Pipelined staging.  Each tile (or 64-deep k-slice of it) is copied
//   into a three-stage shared-memory ring with cp.async while the earlier
//   ones compute: the A rows and the tile's 64 x 128 B slab; the indices
//   of the tiles to stage next are loaded an iteration ahead.
// - A path per tile.  The block counts the staged tile's nonzeros (warp
//   ballots, a block sum) and takes one of two uniform branches:
//   below kMmaMinDensity, the zero-skipping walk (one B slab row read and
//   four FFMAs a lane per nonzero); at or above it, the 3xTF32 tensor-core
//   product (operands split into tf32 hi/lo in registers, mma.sync
//   m16n8k8 .tf32 into fresh fragments added to the running sum with fp32
//   adds, since the tensor cores do not round their own additions to
//   nearest; wgmma is later work).  The two paths
//   keep separate accumulators, summed once at the end.  The threshold is
//   one constant (tile_core.cuh), set from a sweep on the card (PERF.md).
// - 128 columns per block (the first design took 64), so each A tile
//   crosses L2 half as often.
// - Offsets into flat_values, B, the partials and out are 64-bit: the
//   stream can exceed 2^31 elements.  Ragged bm, bk and N are masked; a bk
//   that is not a multiple of 8 is zero-padded in shared memory.
// - Non-finite input.  Neither path gives the TPU kernel's answer where B
//   holds an Inf or NaN (the walk never multiplies a zero of A, and the
//   3xTF32 split turns Inf into NaN), nor where A holds one or a value of
//   |x| >= 3.401993e38 (the split turns it into NaN), so a call first
//   checks B on the card (tile_core's nonfinite_kernel, one read of B,
//   writing flags, with A's flag from the plan copied after them): where
//   either is set the tile walk returns at once and
//   tile_core's every_entry_kernel, launched beside it,
//   multiplies every tile entry in fp32 FFMAs into the same outputs and
//   partials, which gives 0 * Inf = NaN and a nonzero times Inf = +-Inf as
//   the TPU's dense product does (on finite B it is the one that returns
//   at once).  No host sync: the flag is read on the device only.  Finite
//   inputs agree with the reference within fp32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_core.cuh"

namespace {

using namespace tile_core;

// the ring (kStages x (A slice + B slab)) and the block sum
constexpr size_t kSmemBytes =
    sizeof(float) * kStages * (static_cast<size_t>(kAFloats) + kBFloats) +
    sizeof(int) * kWarps;
static_assert(kRows * kEStride <= kStages * (kAFloats + kBFloats),
              "the epilogue tile reuses the ring");

// chunks[i] = (window, first, end, slot): positions [first, end) of order;
// slot < 0 writes the window's rows of out, else partial slot `slot`.
__global__ void __launch_bounds__(kThreads, 1)
dense_tile_spmm_kernel(const int* __restrict__ order,
                       const int* __restrict__ step_col,
                       const float* __restrict__ flat_values,
                       const float* __restrict__ b,
                       const int* __restrict__ flags,
                       const int4* __restrict__ chunks,
                       float* __restrict__ out,
                       float* __restrict__ partial,
                       int n_tiles, int bm, int bk, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // stage st: A slice at smem + st*kAFloats, B slab at b_ring + st*kBFloats
  float* const b_ring = smem + kStages * kAFloats;
  int* red = reinterpret_cast<int*>(b_ring + kStages * kBFloats);

  const int4 ch = chunks[blockIdx.x / n_tiles];
  const int n0 = (blockIdx.x % n_tiles) * kCols;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, bm - r0);
  const int cols = min(kCols, n - n0);
  const int n_slices = (bk + kSlice - 1) / kSlice;
  const int items = (ch.z - ch.y) * n_slices;
  const bool vec_a = (bk & 3) == 0 && aligned16(flat_values);
  const bool vec_b = (n & 3) == 0 && aligned16(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // A or B holds a value the split cannot carry: every_entry_kernel
  // writes the output instead
  if (route_every_entry(flags)) return;

  // the cells no copy writes stay zero
  zero_smem(smem, kStages * (kAFloats + kBFloats));
  __syncthreads();

  // start staging item `it` (tile t, k-slice it % n_slices, B k-block col)
  // into stage st
  auto fetch = [&](int it, int st, int t, int col) {
    const int k0 = (it % n_slices) * kSlice;
    const int width = min(kSlice, bk - k0);
    const int kw8 = (width + 7) & ~7, pad = kw8 - width;
    float* a_stage = smem + st * kAFloats;
    float* b_stage = b_ring + st * kBFloats;
    if (pad) {
      // a narrower last slice: clear what a wider one left in [width, kw8)
      for (int i = threadIdx.x; i < kRows * pad; i += kThreads)
        a_stage[(i / pad) * kAStride + width + i % pad] = 0.f;
      for (int i = threadIdx.x; i < pad * kBStride; i += kThreads)
        b_stage[width * kBStride + i] = 0.f;
    }
    stage_block(a_stage, kAStride,
                flat_values + (static_cast<int64_t>(t) * bm + r0) * bk + k0,
                bk, rows, width, vec_a);
    stage_block(b_stage, kBStride,
                b + (static_cast<int64_t>(col) * bk + k0) * n + n0, n, width,
                cols, vec_b);
  };
  auto tile_of = [&](int it) { return order[ch.y + it / n_slices]; };

  MmaAcc acc_mma;
  WalkAcc acc_walk;
  zero(acc_mma);
  zero(acc_walk);

  // fill all stages but one; the tile and k-block of the next item to
  // stage, and the tile of the one after it, are loaded an iteration ahead
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < items) {
      const int t = tile_of(it);
      fetch(it, it, t, step_col[t]);
    }
    cp_async_commit();
  }
  int t_next = kStages - 1 < items ? tile_of(kStages - 1) : 0;
  int c_next = kStages - 1 < items ? step_col[t_next] : 0;
  int t_after = kStages < items ? tile_of(kStages) : 0;
  for (int it = 0; it < items; ++it) {
    const int st = it % kStages;
    const int ahead = it + kStages - 1;
    if (ahead < items) fetch(ahead, ahead % kStages, t_next, c_next);
    cp_async_commit();
    t_next = t_after;
    c_next = ahead + 1 < items ? step_col[t_after] : 0;
    t_after = ahead + 2 < items ? tile_of(ahead + 2) : 0;
    cp_async_wait<kStages - 1>();
    __syncthreads();

    float* a_stage = smem + st * kAFloats;
    float* b_stage = b_ring + st * kBFloats;
    const int width = min(kSlice, bk - (it % n_slices) * kSlice);
    uint64_t occ;
    const int count = occupancy(a_stage, width, occ);
    if (lane == 0) red[warp] = count;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    if (static_cast<float>(total) >= kMmaMinDensity * rows * width)
      mma_tile(acc_mma, a_stage, b_stage, (width + 7) >> 3);
    else
      walk_tile(acc_walk, a_stage, b_stage, occ);
    __syncthreads();  // a later iteration refills this stage
  }
  cp_async_wait<0>();

  // sum the two accumulators through shared memory and write once
  float* e = smem;
  store_mma(acc_mma, e);
  __syncthreads();
  float* dst = ch.w < 0
                   ? out + (static_cast<int64_t>(ch.x) * bm + r0) * n + n0
                   : partial + (static_cast<int64_t>(ch.w) * bm + r0) * n + n0;
  write_tile(dst, n, rows, cols, (n & 3) == 0, acc_walk, e);
}

// The dense tile stream's cells, for every_entry_kernel.
struct DenseCells {
  const float* values;
  int bk;
  __device__ float cell(int64_t row, int c) const {
    return values[row * bk + c];
  }
};

// For each (window, first slot, end slot) of `reduce`: out's window rows =
// the window's partials summed in slot (chunk) order; zeros if it has none.
__global__ void __launch_bounds__(256)
dense_tile_reduce_kernel(const int* __restrict__ reduce, int n_reduce,
                         const float* __restrict__ partial,
                         float* __restrict__ out, int bm, int n) {
  const int64_t count = static_cast<int64_t>(bm) * n;
  for (int e = blockIdx.y; e < n_reduce; e += gridDim.y) {
    const int w = reduce[3 * e], s0 = reduce[3 * e + 1],
              s1 = reduce[3 * e + 2];
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      float s = 0.f;
      for (int slot = s0; slot < s1; ++slot) s += partial[slot * count + i];
      out[w * count + i] = s;
    }
  }
}

}  // namespace

// order: (T,) tile indices sorted by window; step_col: (T,); flat_values:
// (T, bm, bk); b: (k, n) row-major, contiguous; a_flag: one int on the
// device, nonzero where flat_values holds a value the split cannot carry;
// flags: kFlagInts ints of scratch on the device (nonfinite_kernel's);
// chunks: (n_chunks, 4) int32 (window,
// first, end, slot) over order; reduce: (n_reduce, 3) int32 (window, first
// slot, end slot); partial: (n_slots, bm, n) scratch; out: (num_windows*bm,
// n), every element written.  Four launches: the check of b, the tile
// walk and the every-entry kernel (one of these two returns at once, by
// the check), then the reduce pass.
extern "C" int dense_tile_spmm_launch(const int* order, const int* step_col,
                                      const float* flat_values,
                                      const float* b, int k,
                                      const int* a_flag, int* flags,
                                      const int* chunks,
                                      int n_chunks, const int* reduce,
                                      int n_reduce, float* partial,
                                      float* out, int bm, int bk, int n,
                                      void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + kCols - 1) / kCols;
  if (n_chunks > 0) {
    cudaError_t err = allow_smem(dense_tile_spmm_kernel, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_nonfinite(b, static_cast<int64_t>(k) * n, a_flag, flags,
                           st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(n_chunks) * n_tiles,
                    (bm + kRows - 1) / kRows);
    dense_tile_spmm_kernel<<<grid, kThreads, kSmemBytes, st>>>(
        order, step_col, flat_values, b, flags,
        reinterpret_cast<const int4*>(chunks), out, partial, n_tiles, bm, bk,
        n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_every_entry(DenseCells{flat_values, bk}, order, nullptr,
                             reinterpret_cast<const int4*>(chunks), step_col,
                             b, flags, out, partial, n_chunks, bm, bk, n, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t count = static_cast<int64_t>(bm) * n;
  const dim3 rgrid(static_cast<unsigned>(
                       (count + 255) / 256 < 64 ? (count + 255) / 256 : 64),
                   n_reduce < 1 ? 1 : (n_reduce < 65535 ? n_reduce : 65535));
  dense_tile_reduce_kernel<<<rgrid, 256, 0, st>>>(reduce, n_reduce, partial,
                                                  out, bm, n);
  return static_cast<int>(cudaGetLastError());
}
