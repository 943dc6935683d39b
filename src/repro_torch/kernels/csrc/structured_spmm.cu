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
// bk is at most tile_core::kSlice (64), one staged slice.  Offsets are
// 64-bit.
//
// bitmap_tile_spmm (on the tile core, like nm_tile_spmm): B6's grid and
// ring; a stage holds the tile's occupancy words, its packed values and
// the B slab (a bk above 64 is walked as 64-deep k-slices, each staging the
// tile's whole words and values rows, since a rank counts every earlier
// column).  The path is chosen per tile on the device, from the popcount of
// the staged words against the same kMmaMinDensity:
// - at or above it: decode, then the 3xTF32 product.  Every cell of the
//   dense (rows, 64) tile is computed in parallel, a lane per column of a
//   32-bit word: a set bit takes the value at its exclusive rank (the
//   __popc of the row's words below it), clamped to row_cap - 1 as the
//   reference's _bitmap_expand clips; a clear bit, or a column past bk,
//   gives 0.0.  (The first design walked every set bit with __ffs and a
//   running rank: one shared-memory float4 and four FFMAs per nonzero, 10 %
//   of its bound at 50 % density.)
// - below it: the bit walk, the core's walk layout (a warp on 16 rows, a
//   lane on 4 columns, rows i and i + 8 together), each row's values read
//   at its running rank, straight from the ring: nothing is decoded.
//
// Non-finite input: a call first checks B on the card (tile_core's
// nonfinite_kernel, which also copies A's flag from the plan); both
// kernels read its flags (route_every_entry) and return at once where B
// holds an Inf or NaN, or A or B a value the 3xTF32 split cannot carry
// (an Inf, a NaN, |x| >= 3.401993e38); tile_core's every_entry_kernel,
// launched beside them, then expands every tile as the reference does
// (NmCells, BitmapCells) and multiplies every entry in fp32 FFMAs, as the
// TPU kernels' dense product does.  The slot and bit walks multiply only
// the packed values, and the 3xTF32 split turns such a value into NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_core.cuh"

namespace {

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
                    const int* __restrict__ flags,
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
  // A or B holds a value the split cannot carry: every_entry_kernel
  // writes the output instead
  if (tc::route_every_entry(flags)) return;

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
    tc::cp_async_wait_ring(stages);
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

// Floats of one bitmap ring stage: the B slab, then the tile's occupancy
// words and its packed values (each with room for the shift stage_flat
// applies, a multiple of 4).
__host__ __device__ inline int bitmap_words_floats(int n_words) {
  return (tc::kRows * n_words + 4 + 3) & ~3;
}
__host__ __device__ inline int bitmap_stage_floats(int n_words, int row_cap) {
  return tc::kBFloats + bitmap_words_floats(n_words) +
         ((tc::kRows * row_cap + 4 + 3) & ~3);
}
// Floats of shared memory: the ring, the decoded tile and the block sum.
__host__ __device__ inline int bitmap_smem_floats(int stages, int n_words,
                                                  int row_cap) {
  return stages * bitmap_stage_floats(n_words, row_cap) + tc::kAFloats +
         tc::kWarps;
}
static_assert(tc::kRows * tc::kEStride <= tc::kBFloats + tc::kAFloats,
              "the epilogue tile reuses one stage and the decoded tile");

// Decode a k-slice of the staged bitmap tile (values v_s, row stride
// row_cap) into the dense tile a_s, from the occupancy registers of
// bitmap_walk's layout (lane i < 16 of warp w: row 16*w + i's bits of the
// slice in occ, masked to its width, and the row's bits before the slice
// in rank0): warp w writes rows 16*w + [0, 16), a lane per column of each
// 32-bit half.  A set bit takes the value at its exclusive rank, clamped to
// row_cap - 1 as the reference clips; a clear bit gives 0.0.  Only the
// value read touches shared memory before the store, and the 16 rows are
// independent, so their loads overlap (the first version re-read the words
// from shared memory for every (row, word): 3 dependent loads a cell row,
// twice the tile's tensor-core time).
__device__ __forceinline__ void bitmap_decode(float* a_s, const float* v_s,
                                              int row_cap, uint64_t occ,
                                              int rank0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  const int r0 = tc::kWalkRows * warp;
#pragma unroll
  for (int i = 0; i < tc::kWalkRows; ++i) {
    const uint64_t m = __shfl_sync(~0u, occ, i);
    const int base = __shfl_sync(~0u, rank0, i);
    const uint32_t lo = static_cast<uint32_t>(m);
    const uint32_t hi = static_cast<uint32_t>(m >> 32);
    const float* vr = v_s + (r0 + i) * row_cap;
    float* ar = a_s + (r0 + i) * tc::kAStride;
    const int rank_lo = min(base + __popc(lo & below), row_cap - 1);
    const int rank_hi =
        min(base + __popc(lo) + __popc(hi & below), row_cap - 1);
    ar[lane] = (lo >> lane) & 1u ? vr[rank_lo] : 0.f;
    ar[32 + lane] = (hi >> lane) & 1u ? vr[rank_hi] : 0.f;
  }
}

// acc += k-slice `slice` of the staged bitmap tile @ B slab, walking set
// bits: warp w on rows 16*w + i, rows i and i + 8 together; lane i < 16
// holds in occ the slice's bits of row 16*w + i and in rank0 the count of
// that row's bits before the slice.  A value is read at its running rank,
// clamped to row_cap - 1.
__device__ __forceinline__ void bitmap_walk(tc::WalkAcc& acc,
                                            const float* v_s, int row_cap,
                                            const float* b_s, uint64_t occ,
                                            int rank0) {
  const float* vals = v_s + tc::kWalkRows * (threadIdx.x >> 5) * row_cap;
#pragma unroll
  for (int i = 0; i < tc::kWalkRows / 2; ++i) {
    const int j = i + tc::kWalkRows / 2;
    uint64_t mi = __shfl_sync(~0u, occ, i);
    uint64_t mj = __shfl_sync(~0u, occ, j);
    int ki = __shfl_sync(~0u, rank0, i);
    int kj = __shfl_sync(~0u, rank0, j);
    const float* vi = vals + i * row_cap;
    const float* vj = vals + j * row_cap;
    while (mi | mj) {
      if (mi) {
        const int c = __ffsll(mi) - 1;
        mi &= mi - 1u;
        tc::fma_row(acc[i], vi[min(ki, row_cap - 1)], b_s + c * tc::kBStride);
        ++ki;
      }
      if (mj) {
        const int c = __ffsll(mj) - 1;
        mj &= mj - 1u;
        tc::fma_row(acc[j], vj[min(kj, row_cap - 1)], b_s + c * tc::kBStride);
        ++kj;
      }
    }
  }
}

__global__ void __launch_bounds__(tc::kThreads, 1)
bitmap_tile_spmm_kernel(const int* __restrict__ order,
                        const int* __restrict__ seg,
                        const int* __restrict__ step_col,
                        const uint32_t* __restrict__ words,
                        const float* __restrict__ values,
                        const float* __restrict__ b,
                        const int* __restrict__ flags,
                        float* __restrict__ out,
                        int n_tiles, int bm, int bk, int n_words,
                        int row_cap, int n, int stages) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // stage st at smem + st*stage: B slab, occupancy words, packed values
  const int stage = bitmap_stage_floats(n_words, row_cap);
  const int w_off = tc::kBFloats, v_off = w_off + bitmap_words_floats(n_words);
  float* const a_s = smem + stages * stage;  // the decoded tile
  int* const red = reinterpret_cast<int*>(a_s + tc::kAFloats);

  const int w = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * tc::kCols;
  const int r0 = blockIdx.y * tc::kRows;
  const int rows = min(tc::kRows, bm - r0);
  const int cols = min(tc::kCols, n - n0);
  const int n_slices = (bk + tc::kSlice - 1) / tc::kSlice;
  const bool vec_b = (n & 3) == 0 && tc::aligned16(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // A or B holds a value the split cannot carry: every_entry_kernel
  // writes the output instead
  if (tc::route_every_entry(flags)) return;

  // the cells no copy or decode writes stay zero
  tc::zero_smem(smem, stages * stage + tc::kAFloats);
  __syncthreads();

  const int s0 = seg[w], s1 = seg[w + 1];
  const int items = (s1 - s0) * n_slices;
  // start staging item `it` (tile t, k-slice it % n_slices, B k-block col)
  // into stage st
  auto fetch = [&](int it, int st, int t, int col) {
    const int k0 = (it % n_slices) * tc::kSlice;
    const int width = min(tc::kSlice, bk - k0);
    const int kw8 = (width + 7) & ~7;
    float* base = smem + st * stage;
    // a narrower last slice: clear what a wider one left in [width, kw8)
    for (int i = threadIdx.x; i < (kw8 - width) * tc::kBStride;
         i += tc::kThreads)
      base[width * tc::kBStride + i] = 0.f;
    tc::stage_block(base, tc::kBStride,
                    b + (static_cast<int64_t>(col) * bk + k0) * n + n0, n,
                    width, cols, vec_b);
    const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
    tc::stage_flat(reinterpret_cast<uint32_t*>(base + w_off),
                   words + row0 * n_words, rows * n_words);
    tc::stage_flat(base + v_off, values + row0 * row_cap, rows * row_cap);
  };
  auto tile_of = [&](int it) { return order[s0 + it / n_slices]; };

  tc::MmaAcc acc_mma;
  tc::WalkAcc acc_walk;
  tc::zero(acc_mma);
  tc::zero(acc_walk);

  // fill all stages but one; the tile and k-block of the next item to
  // stage, and the tile of the one after it, are loaded an iteration ahead
  for (int it = 0; it < stages - 1; ++it) {
    if (it < items) {
      const int t = tile_of(it);
      fetch(it, it, t, step_col[t]);
    }
    tc::cp_async_commit();
  }
  int t_next = stages - 1 < items ? tile_of(stages - 1) : 0;
  int c_next = stages - 1 < items ? step_col[t_next] : 0;
  int t_after = stages < items ? tile_of(stages) : 0;
  for (int it = 0; it < items; ++it) {
    const int st = it % stages;
    const int ahead = it + stages - 1;
    if (ahead < items) fetch(ahead, ahead % stages, t_next, c_next);
    tc::cp_async_commit();
    const int t = tile_of(it);
    t_next = t_after;
    c_next = ahead + 1 < items ? step_col[t_after] : 0;
    t_after = ahead + 2 < items ? tile_of(ahead + 2) : 0;
    tc::cp_async_wait_ring(stages);
    __syncthreads();

    const int slice = it % n_slices;
    const int width = min(tc::kSlice, bk - slice * tc::kSlice);
    const int64_t row0 = static_cast<int64_t>(t) * bm + r0;
    const float* b_stage = smem + st * stage;
    const uint32_t* w_s =
        reinterpret_cast<const uint32_t*>(b_stage + w_off) +
        tc::flat_shift(words + row0 * n_words);
    const float* v_s =
        b_stage + v_off + tc::flat_shift(values + row0 * row_cap);
    // lane i < 16: row 16*warp + i's bits of this slice (columns past
    // width, hence past bk, masked off) and its bits before the slice
    uint64_t occ = 0u;
    int rank0 = 0;
    const int r = tc::kWalkRows * warp + lane;
    if (lane < tc::kWalkRows && r < rows) {
      const uint32_t* wr = w_s + r * n_words;
      for (int i = 0; i < 2 * slice; ++i) rank0 += __popc(wr[i]);
      occ = wr[2 * slice];
      if (2 * slice + 1 < n_words)
        occ |= static_cast<uint64_t>(wr[2 * slice + 1]) << 32;
      if (width < 64) occ &= (uint64_t{1} << width) - 1u;
    }
    const int count = __reduce_add_sync(~0u, __popcll(occ));
    if (lane == 0) red[warp] = count;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int i = 0; i < tc::kWarps; ++i) total += red[i];
    if (static_cast<float>(total) >= tc::kMmaMinDensity * rows * width) {
      bitmap_decode(a_s, v_s, row_cap, occ, rank0);
      __syncthreads();
      tc::mma_tile(acc_mma, a_s, b_stage, (width + 7) >> 3);
    } else {
      bitmap_walk(acc_walk, v_s, row_cap, b_stage, occ, rank0);
    }
    __syncthreads();  // a later iteration refills this stage and a_s
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // sum the two accumulators through shared memory (the last stage and the
  // decoded tile, contiguous) and write once
  float* e = smem + (stages - 1) * stage;
  tc::store_mma(acc_mma, e);
  __syncthreads();
  tc::write_tile(out + (static_cast<int64_t>(w) * bm + r0) * n + n0, n, rows,
                 cols, (n & 3) == 0, acc_walk, e);
}

// The N:M stream's cells, for every_entry_kernel: each the sum, in slot
// order from 0.0, of the slots whose position selects it (nm_decode's).
struct NmCells {
  const float* values;
  const uint32_t* codes;
  int n_pat, m_pat, gk;
  __device__ float cell(int64_t row, int c) const {
    const int g = c / m_pat;
    const uint32_t x = static_cast<uint32_t>(c - g * m_pat);
    const uint32_t code = codes[row * gk + g];
    const float* v = values + row * n_pat * gk + g;
    float sum = 0.f;
    for (int j = 0; j < n_pat; ++j)
      sum += ((code >> (8 * j)) & 0xFFu) == x ? v[j * gk] : 0.f;
    return sum;
  }
};

// The bitmap stream's cells, for every_entry_kernel: a set bit's value at
// its exclusive rank in the row, clamped to row_cap - 1; else 0.0.
struct BitmapCells {
  const uint32_t* words;
  const float* values;
  int n_words, row_cap;
  __device__ float cell(int64_t row, int c) const {
    const uint32_t* w = words + row * n_words;
    const uint32_t word = w[c >> 5];
    const uint32_t bit = c & 31;
    if (!((word >> bit) & 1u)) return 0.f;
    int rank = __popc(word & ((1u << bit) - 1u));
    for (int i = 0; i < (c >> 5); ++i) rank += __popc(w[i]);
    return values[row * row_cap + min(rank, row_cap - 1)];
  }
};

template <int NPAT, bool MMA>
cudaError_t launch_nm(int num_windows, cudaStream_t stream, const int* order,
                      const int* seg, const int* step_col,
                      const float* nm_values, const uint32_t* nm_codes,
                      const float* b, const int* flags, float* out, int bm,
                      int bk, int m_pat, int n) {
  const int gk = bk / m_pat;
  // three ring stages where they fit in a block's shared memory, else two
  size_t max_optin = 0;
  cudaError_t err = tc::smem_optin(max_optin);
  if (err != cudaSuccess) return err;
  int stages = tc::kStages;
  while (stages > 2 &&
         sizeof(float) * nm_smem_floats(MMA, stages, NPAT * gk, gk) >
             max_optin)
    --stages;
  const size_t smem =
      sizeof(float) * nm_smem_floats(MMA, stages, NPAT * gk, gk);
  err = tc::allow_smem(nm_tile_spmm_kernel<NPAT, MMA>, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + tc::kCols - 1) / tc::kCols;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + tc::kRows - 1) / tc::kRows);
  nm_tile_spmm_kernel<NPAT, MMA><<<grid, tc::kThreads, smem, stream>>>(
      order, seg, step_col, nm_values, nm_codes, b, flags, out, n_tiles, bm,
      bk, m_pat, n, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tc::launch_every_entry(NmCells{nm_values, nm_codes, NPAT, m_pat, gk},
                                order, seg, nullptr, step_col, b, flags, out,
                                nullptr, num_windows, bm, bk, n, stream);
}

template <int NPAT>
cudaError_t launch_nm_path(int num_windows, cudaStream_t stream,
                           const int* order, const int* seg,
                           const int* step_col, const float* nm_values,
                           const uint32_t* nm_codes, const float* b,
                           const int* flags, float* out, int bm, int bk,
                           int m_pat, int n) {
  // n/m at or above the tile core's density threshold: decode + 3xTF32
  if (static_cast<float>(NPAT) >= tc::kMmaMinDensity * m_pat)
    return launch_nm<NPAT, true>(num_windows, stream, order, seg, step_col,
                                 nm_values, nm_codes, b, flags, out, bm, bk,
                                 m_pat, n);
  return launch_nm<NPAT, false>(num_windows, stream, order, seg, step_col,
                                nm_values, nm_codes, b, flags, out, bm, bk,
                                m_pat, n);
}

}  // namespace

// order: (T,) tile indices sorted by window; seg: (num_windows+1,) segment
// offsets into order; step_col: (T,); nm_values: (T, bm, n_pat*bk/m_pat);
// nm_codes: (T, bm, bk/m_pat); b: (k, n) row-major, contiguous; a_flag:
// one int on the device, nonzero where the tile values hold a value the
// split cannot carry; flags: kFlagInts ints of scratch on the device
// (nonfinite_kernel's); out:
// (num_windows*bm, n), every element written.  1 <= n_pat <= 4, m_pat
// dividing bk and bk <= 64, else cudaErrorInvalidValue.
extern "C" int nm_tile_spmm_launch(const int* order, const int* seg,
                                   const int* step_col,
                                   const float* nm_values,
                                   const int* nm_codes, const float* b,
                                   int k, const int* a_flag, int* flags,
                                   float* out,
                                   int num_windows, int bm,
                                   int bk, int n, int n_pat, int m_pat,
                                   void* stream) {
  if (n_pat < 1 || n_pat > 4 || m_pat <= 0 || bk % m_pat || bk > tc::kSlice)
    return cudaErrorInvalidValue;
  if (num_windows == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* codes = reinterpret_cast<const uint32_t*>(nm_codes);
  cudaError_t err =
      tc::launch_nonfinite(b, static_cast<int64_t>(k) * n, a_flag, flags, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_pat) {
    case 1:
      err = launch_nm_path<1>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, flags, out, bm, bk, m_pat,
                              n);
      break;
    case 2:
      err = launch_nm_path<2>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, flags, out, bm, bk, m_pat,
                              n);
      break;
    case 3:
      err = launch_nm_path<3>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, flags, out, bm, bk, m_pat,
                              n);
      break;
    default:  // n_pat == 4
      err = launch_nm_path<4>(num_windows, st, order, seg, step_col,
                              nm_values, codes, b, flags, out, bm, bk, m_pat,
                              n);
  }
  return static_cast<int>(err);
}

// words: (T, bm, n_words) with n_words = ceil(bk/32); values:
// (T, bm, row_cap); the other arguments as for nm_tile_spmm_launch.
// cudaErrorInvalidValue where even one ring stage does not fit in a
// block's shared memory (a row_cap above about 300 at n_words = 2).
extern "C" int bitmap_tile_spmm_launch(const int* order, const int* seg,
                                       const int* step_col, const int* words,
                                       const float* values, const float* b,
                                       int k, const int* a_flag, int* flags,
                                       float* out, int num_windows, int bm,
                                       int bk, int n, int row_cap,
                                       void* stream) {
  const int n_words = (bk + 31) / 32;
  if (row_cap <= 0 || bk <= 0) return cudaErrorInvalidValue;
  if (num_windows == 0 || n == 0) return 0;
  // three ring stages where they fit in a block's shared memory, else fewer
  size_t max_optin = 0;
  cudaError_t err = tc::smem_optin(max_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  int stages = tc::kStages;
  while (stages > 1 &&
         sizeof(float) * bitmap_smem_floats(stages, n_words, row_cap) >
             max_optin)
    --stages;
  const size_t smem =
      sizeof(float) * bitmap_smem_floats(stages, n_words, row_cap);
  err = tc::allow_smem(bitmap_tile_spmm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = tc::launch_nonfinite(b, static_cast<int64_t>(k) * n, a_flag, flags,
                             st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + tc::kCols - 1) / tc::kCols;
  const dim3 grid(static_cast<unsigned>(n_tiles) * num_windows,
                  (bm + tc::kRows - 1) / tc::kRows);
  bitmap_tile_spmm_kernel<<<grid, tc::kThreads, smem, st>>>(
      order, seg, step_col, reinterpret_cast<const uint32_t*>(words), values,
      b, flags, out, n_tiles, bm, bk, n_words, row_cap, n, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::launch_every_entry(
      BitmapCells{reinterpret_cast<const uint32_t*>(words), values, n_words,
                  row_cap},
      order, seg, nullptr, step_col, b, flags, out, nullptr, num_windows, bm,
      bk, n, st));
}
