// SDDMM of NeutronSparse on Hopper: (X @ Y) sampled at a plan's nonzeros,
// on the same two paths as the SpMM.
//
// Replaces: the two Pallas TPU kernels of repro/kernels/sddmm.py,
//   - dense_tile_sddmm (matrix path): for every active (window, k-block)
//     tile t of the plan's stream,
//       tiles[t] = Xp[w[t]*bm : +bm, :] @ Yp[:, c[t]*bk : +bk]
//     on a sequential grid with the X row panel and the Y column slab in
//     VMEM, returning the fp32 stream (T, bm, bk), of which the caller
//     reads the plan's core slots only;
//   - gather_sddmm (vector path): out[i] = X[rows[i]] . Yt[cols[i]] for
//     every fringe nonzero, in input order, with both dense panels resident
//     in VMEM and one dot per lane of a 128-lane output row; the caller
//     then gathers the dots into the SDDMM output.
//
// dense_tile_sddmm on the card computes only what the caller reads: the
// value at each core nonzero's slot, written straight to its position in
// the SDDMM output.  One SDDMM cell depends on its own row of X and its own
// column of Y only, so this gives the same values as the whole tile
// product, Inf and NaN included; the (T, bm, bk) stream (5.85 GB at
// Reddit scale, 2.46 % of it read) is never built.
//
// What bounds them on the H100:
//   - dense_tile_sddmm: 2*D flops per core nonzero, one X row (4*D bytes)
//     and one Y^T row per nonzero, each read once in the bound; at D = 256
//     the bound is the fp32 operations (PERF.md).  What it moves in fact is
//     an X row per nonzero through L2 (X's window panel, 6.4 MB at Reddit
//     scale and D = 256, stays in the 50 MB L2), while each Y^T row is read
//     from device memory about once.
//   - gather_sddmm does 2*D flops per nonzero for two gathered D-wide rows
//     (8*D bytes): 0.25 flops/byte, bound by memory traffic.  The traffic
//     that counts is the Y^T rows fetched through the 50 MB L2 from device
//     memory, not the once-each input bytes: at Reddit scale and D = 256
//     the fringe gathers 35.5 GB of Y^T row slices from a 238.6 MB panel.
//
// Design:
//   - dense_tile_sddmm (sampled_sddmm_kernel): the host orders the core
//     nonzeros by k-block (then by tile slot) once, from the structure
//     alone, and cuts each k-block's run into segments of at most a few
//     thousand nonzeros (kernels/sddmm.py sampled_index).  One block per
//     segment stages its k-block's bk rows of Y^T (permuted and padded as
//     SpMM pads B; 64 KB at bk = 64, D = 256) in shared memory, d_chunk
//     columns at a time where D is wider than the stage.  Its warps take
//     32 nonzeros at a time, a (X row, Y^T row, position) triple per lane,
//     and kNz of them at once by shuffles: each lane loads its float4s of
//     the kNz X rows from L2 (kNz * D/128 loads in flight a lane), dots
//     them against the staged rows in a fixed order, and a butterfly
//     reduction in a fixed order finishes each dot; the lane that owns the
//     nonzero writes it once (a D chunk past the first adds to it).  No
//     atomics, so two calls are bit-identical.  D not a multiple of 4, or
//     panels not 16-byte aligned, take the same walk with 4-byte loads.
//   - gather_sddmm (sddmm_rows_kernel), the row walk of gather_spmm's B2
//     turned into dots: the host sorts the fringe by row once, from the
//     structure alone (core/plan_ir.py fringe_row_order: per row a CSR
//     offset, per entry its Y^T row and its position in the SDDMM output).
//     A warp takes one row and one column slice of kSlice columns of D.  It
//     holds the X row's slice in registers (read once per row), gathers the
//     Y^T row slices of 32 nonzeros at a time, 16 bytes a lane, with
//     min(32, kSlice/4) lanes on one nonzero (so one load instruction
//     fetches 512 bytes, as in gather_spmm's walk) and kUnroll loads in
//     flight a lane, while the next 32 (col, pos) pairs load.  It finishes
//     the 32 dots with one transpose reduction over each nonzero's lanes
//     (31 shuffle-adds a lane where 32 lanes share a nonzero, 15 where 16
//     do; after it each lane holds one dot), where the TPU layout's one dot
//     per lane took five shuffles per dot.  Each dot is written at its
//     final position; a later pass reads what is there at the start of the
//     batch, behind the gathers.  The slices are ordered passes, one
//     launch each on the stream: the first writes, each later one adds its
//     slice's part, so a dot is summed in a fixed order, no atomics, and
//     two calls are bit-identical.  Slices keep the live panel small: at
//     D = 256 the Y^T columns gathered at a time are a kSlice-wide strip,
//     29.8 MB of the 238.6 MB at 32 columns (fits the L2), 59.6 MB at 64.
//     D not a multiple of 4, or panels not 16-byte aligned, take the same
//     walk with 4-byte loads.  The index, the sums and the dots are read
//     and written once a pass with the streaming cache hint (evict first),
//     so that they push less of the Y^T strip out of L2.  The slice width,
//     unroll depth and hint (kSliceCols, kUnrollLoads, on) were chosen on
//     the card by bench_torch/gather_sweep.py (PERF.md), which runs the
//     others through gather_sddmm_variant_launch.  (The
//     first design, one warp per nonzero in input order with two float4
//     loads in flight a lane and a 5-step reduction per dot, took 10.8 ms
//     at Reddit scale, at the card's ceiling for random 1 KB rows from
//     device memory.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- dense_tile_sddmm: the sampled product --------------------------------

constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;
constexpr int kNz = 4;  // nonzeros a warp dots at once
// shared memory a block stages Y^T rows in (3 blocks fit on an SM at 64 KB)
constexpr int kStageBytes = 96 * 1024;

template <bool kVec>
__global__ void __launch_bounds__(kSThreads)
sampled_sddmm_kernel(const int* __restrict__ seg_kb,
                     const int* __restrict__ seg_ptr,
                     const int* __restrict__ x_row,
                     const int* __restrict__ y_row,
                     const int* __restrict__ pos,
                     const float* __restrict__ xp,
                     const float* __restrict__ ypt,
                     float* __restrict__ out, int bk, int d, int d_chunk) {
  extern __shared__ float4 smem4[];
  float* const ys = reinterpret_cast<float*>(smem4);
  const int y0 = seg_kb[blockIdx.x] * bk;
  const int beg = seg_ptr[blockIdx.x];
  const int end = seg_ptr[blockIdx.x + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int dc = 0; dc < d; dc += d_chunk) {
    const int w = min(d_chunk, d - dc);
    __syncthreads();  // the last chunk's dots have read ys
    // this k-block's rows [y0, y0 + bk) of Y^T, columns [dc, dc + w)
    if constexpr (kVec) {
      const int w4 = w / 4;
      for (int i = threadIdx.x; i < bk * w4; i += kSThreads) {
        const int r = i / w4, c = i % w4;
        reinterpret_cast<float4*>(ys + r * d_chunk)[c] = __ldg(
            reinterpret_cast<const float4*>(
                ypt + static_cast<int64_t>(y0 + r) * d + dc) + c);
      }
    } else {
      for (int i = threadIdx.x; i < bk * w; i += kSThreads) {
        const int r = i / w, c = i % w;
        ys[r * d_chunk + c] =
            __ldg(ypt + static_cast<int64_t>(y0 + r) * d + dc + c);
      }
    }
    __syncthreads();

    for (int base = beg + 32 * warp; base < end; base += 32 * kSWarps) {
      const int e = base + lane;
      const bool mine = e < end;
      // lanes past the end take row 0 of both: valid addresses, unused dots
      int my_x = 0, my_y = 0;
      if (mine) {
        my_x = __ldg(x_row + e);
        my_y = __ldg(y_row + e) - y0;
      }
      const int cnt = min(32, end - base);
      float my_dot = 0.f;
      for (int j0 = 0; j0 < cnt; j0 += kNz) {
        const float* xr[kNz];
        const float* yr[kNz];
        float acc[kNz];
#pragma unroll
        for (int u = 0; u < kNz; ++u) {
          const int xi = __shfl_sync(kFull, my_x, j0 + u);
          const int yi = __shfl_sync(kFull, my_y, j0 + u);
          xr[u] = xp + static_cast<int64_t>(xi) * d + dc;
          yr[u] = ys + yi * d_chunk;
          acc[u] = 0.f;
        }
        if constexpr (kVec) {
#pragma unroll 2
          for (int q = 4 * lane; q < w; q += 128) {
            float4 xv[kNz];
#pragma unroll
            for (int u = 0; u < kNz; ++u)
              xv[u] = __ldg(reinterpret_cast<const float4*>(xr[u] + q));
#pragma unroll
            for (int u = 0; u < kNz; ++u) {
              const float4 yv = *reinterpret_cast<const float4*>(yr[u] + q);
              acc[u] = fmaf(xv[u].x, yv.x, acc[u]);
              acc[u] = fmaf(xv[u].y, yv.y, acc[u]);
              acc[u] = fmaf(xv[u].z, yv.z, acc[u]);
              acc[u] = fmaf(xv[u].w, yv.w, acc[u]);
            }
          }
        } else {
          for (int q = lane; q < w; q += 32) {
#pragma unroll
            for (int u = 0; u < kNz; ++u)
              acc[u] = fmaf(__ldg(xr[u] + q), yr[u][q], acc[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kNz; ++u) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[u] += __shfl_xor_sync(kFull, acc[u], off);
          if (lane == j0 + u) my_dot = acc[u];
        }
      }
      if (mine) {
        const int p = __ldg(pos + e);
        out[p] = dc == 0 ? my_dot : out[p] + my_dot;
      }
    }
  }
}

// ---- gather_sddmm: the row walk -------------------------------------------

constexpr int kRowWarps = 8;  // rows per block, one per warp
// the committed choice of the sweep: 32-column slices (a 29.8 MB strip of
// a 256-wide Y^T at Reddit scale, which fits the L2) and 4 loads in flight
// a lane (32 and 64 columns, 4 and 8 loads came within 3 % of each other;
// 4 take the fewest registers)
constexpr int kSliceCols = 32;
constexpr int kUnrollLoads = 4;

// An int of the index, or a float of the sums, read once a pass: with the
// streaming hint (evict first) where kStream, else through the read-only
// path (the index) or a plain load (the sums, which the pass rewrites).
template <bool kStream>
__device__ __forceinline__ int ld_index(const int* p) {
  if constexpr (kStream) return __ldcs(p);
  else return __ldg(p);
}

template <bool kStream>
__device__ __forceinline__ float ld_sum(const float* p) {
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}

template <bool kStream>
__device__ __forceinline__ void st_sum(float* p, float v) {
  if constexpr (kStream) __stcs(p, v);
  else *p = v;
}

// 4 consecutive floats of a row at column col (zeros past d, or where !ok):
// one 16-byte load (kVec: d a multiple of 4, rows 16-byte aligned), else
// guarded 4-byte loads.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int col, int d,
                                        bool ok) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kVec) {
    if (ok && col < d) r = __ldg(reinterpret_cast<const float4*>(row + col));
  } else {
    if (ok && col < d) r.x = __ldg(row + col);
    if (ok && col + 1 < d) r.y = __ldg(row + col + 1);
    if (ok && col + 2 < d) r.z = __ldg(row + col + 2);
    if (ok && col + 3 < d) r.w = __ldg(row + col + 3);
  }
  return r;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One step of the transpose reduction at width W: p[0, 2W) holds this
// lane's parts of 2W dots; the lane keeps the half its lane bit W selects
// and adds its partner's parts of them (p[0, W) after the step), in a fixed
// order.
template <int W, int N>
__device__ __forceinline__ void transpose_step(float (&p)[N], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? p[i] : p[i + W];
    const float keep = upper ? p[i + W] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// p[0, N) over the N lanes of an aligned group: after it, lane i of the
// group holds in p[0] the sum over the group of everyone's p[i].
template <int N>
__device__ __forceinline__ void transpose_reduce(float (&p)[N], int lane) {
  if constexpr (N >= 32) transpose_step<16>(p, lane);
  if constexpr (N >= 16) transpose_step<8>(p, lane);
  if constexpr (N >= 8) transpose_step<4>(p, lane);
  if constexpr (N >= 4) transpose_step<2>(p, lane);
  if constexpr (N >= 2) transpose_step<1>(p, lane);
}

// One pass: columns [c_base, c_base + kSlice) of every dot.  first: the
// pass starts each dot, else adds its part to the earlier passes' sum;
// last: the pass writes the dots to out at their positions.  Between
// passes the sums live in acc, in the walk's order (a batch's 32 sums are
// 128 contiguous bytes; keeping them in out instead, at the positions,
// took 0.1-0.3 ms more at Reddit scale and more registers).  At most 64
// registers a thread up to 64-column slices, so that 4 blocks fit an SM:
// the walk's loads in flight come from its warps.
// A nonzero's slice is read by kLanes lanes, 16 bytes each, so one load
// instruction of the warp fetches kGroups nonzeros' slices (512 bytes), as
// gather_spmm's walk does.
template <bool kVec, int kSlice, int kUnroll, bool kStream>
__global__ void __launch_bounds__(32 * kRowWarps, kSlice <= 64 ? 4 : 2)
sddmm_rows_kernel(const int* __restrict__ indptr,
                  const int* __restrict__ cols,
                  const int* __restrict__ pos,
                  const float* __restrict__ x,
                  const float* __restrict__ yt,
                  float* __restrict__ out,
                  float* __restrict__ acc,
                  int num_rows, int d, int c_base, int first, int last) {
  // lanes per nonzero, nonzeros side by side, float4s per lane and
  // nonzero, load steps per batch of 32 nonzeros (= a lane's partial dots)
  constexpr int kLanes = kSlice / 4 < 32 ? kSlice / 4 : 32;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kVecs = kSlice / (4 * kLanes);
  constexpr int kSteps = 32 / kGroups;
  static_assert(kVecs >= 1 && kSteps % kUnroll == 0, "slice and unroll");
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= num_rows) return;  // uniform across the warp
  const int beg = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  if (beg == end) return;
  const int grp = lane / kLanes;
  const int sub = lane % kLanes;
  const int c0 = c_base + 4 * sub;
  float4 xv[kVecs];
  const float* xrow = x + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int f = 0; f < kVecs; ++f)
    xv[f] = load4<kVec>(xrow, c0 + 4 * kLanes * f, d, true);
  // the dot this lane ends up holding: nonzero sub * kGroups + grp
  const int j_out = sub * kGroups + grp;

  // the (col, pos) pair of each lane, one batch of 32 ahead: its loads are
  // in flight while a batch is dotted
  int nx_col = 0, nx_pos = 0;
  if (beg + lane < end) {
    nx_col = ld_index<kStream>(cols + beg + lane);
    if (last) nx_pos = ld_index<kStream>(pos + beg + lane);
  }
  for (int base = beg; base < end; base += 32) {
    const int my_col = nx_col;
    const int my_pos = nx_pos;
    const int e = base + 32 + lane;
    if (e < end) {
      nx_col = ld_index<kStream>(cols + e);
      if (last) nx_pos = ld_index<kStream>(pos + e);
    }
    const int cnt = min(32, end - base);
    // where this lane's dot goes, and (a later pass) the earlier passes'
    // sum: read now, so that its latency hides behind the gathers
    const int o_pos = __shfl_sync(kFull, my_pos, j_out);
    const bool o_ok = j_out < cnt;
    float* const sum_at = acc + base + j_out;
    const float prev = (!first && o_ok) ? ld_sum<kStream>(sum_at) : 0.f;
    // p[s]: this lane's part of dot s * kGroups + grp of the batch
    float p[kSteps];
#pragma unroll
    for (int s0 = 0; s0 < kSteps; s0 += kUnroll) {
      if (s0 * kGroups < cnt) {  // uniform across the warp
        float4 yv[kUnroll][kVecs];
        // every Y^T load of the group is issued before the first FFMA
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = (s0 + u) * kGroups + grp;
          const int c = __shfl_sync(kFull, my_col, j);
          const float* yrow = yt + static_cast<int64_t>(c) * d;
#pragma unroll
          for (int f = 0; f < kVecs; ++f)
            yv[u][f] = load4<kVec>(yrow, c0 + 4 * kLanes * f, d, j < cnt);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < kVecs; ++f) acc = dot4(xv[f], yv[u][f], acc);
          p[s0 + u] = acc;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) p[s0 + u] = 0.f;
      }
    }
    // after it, lane (grp, sub) holds dot sub * kGroups + grp = j_out
    transpose_reduce<kSteps>(p, lane);
    if (o_ok) {
      const float sum = first ? p[0] : prev + p[0];
      st_sum<kStream>(last ? out + o_pos : sum_at, sum);
    }
  }
}

template <bool kVec, int kSlice, int kUnroll, bool kStream>
cudaError_t launch_sddmm_rows(const int* indptr, const int* cols,
                              const int* pos, const float* x, const float* yt,
                              float* out, float* acc, int num_rows, int d,
                              cudaStream_t stream) {
  const unsigned blocks = (num_rows + kRowWarps - 1) / kRowWarps;
  for (int c = 0; c < d; c += kSlice) {
    sddmm_rows_kernel<kVec, kSlice, kUnroll, kStream>
        <<<blocks, 32 * kRowWarps, 0, stream>>>(
            indptr, cols, pos, x, yt, out, acc, num_rows, d, c, c == 0,
            c + kSlice >= d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool vec_ok(const float* x, const float* yt, int d) {
  return (d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(yt) & 15u) == 0;
}

}  // namespace

// seg_kb, seg_ptr: n_segments segments of the index arrays, segment s
// holding entries [seg_ptr[s], seg_ptr[s+1]) of k-block seg_kb[s]; x_row,
// y_row, pos: per core nonzero, its row in xp, its row in ypt (in its
// segment's k-block) and its position in out; xp: (rows, d) and ypt:
// (k, d) row-major; out: written at every pos.  vec4 != 0 asks for float4
// loads: d a multiple of 4 and both panels 16-byte aligned.
// cudaErrorInvalidValue where not even 4 columns of bk rows fit the stage.
extern "C" int dense_tile_sddmm_launch(const int* seg_kb, const int* seg_ptr,
                                       int n_segments, const int* x_row,
                                       const int* y_row, const int* pos,
                                       const float* xp, const float* ypt,
                                       float* out, int bk, int d, int vec4,
                                       void* stream) {
  if (n_segments == 0 || d == 0) return 0;
  int d_chunk = kStageBytes / (4 * bk);
  if (vec4) d_chunk &= ~3;
  if (bk <= 0 || d_chunk < 4) return cudaErrorInvalidValue;
  if (d_chunk > d) d_chunk = d;
  const size_t smem = sizeof(float) * static_cast<size_t>(bk) * d_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4) {
    err = cudaFuncSetAttribute(sampled_sddmm_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sampled_sddmm_kernel<true><<<n_segments, kSThreads, smem, s>>>(
        seg_kb, seg_ptr, x_row, y_row, pos, xp, ypt, out, bk, d, d_chunk);
  } else {
    err = cudaFuncSetAttribute(sampled_sddmm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sampled_sddmm_kernel<false><<<n_segments, kSThreads, smem, s>>>(
        seg_kb, seg_ptr, x_row, y_row, pos, xp, ypt, out, bk, d, d_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// indptr: (num_rows+1,) offsets of each X row's entries; cols, pos:
// (nnz,) per entry its row in yt and its position in out; x: (num_rows, d)
// and yt: (K, d) row-major; out[pos[e]] written for every entry, nothing
// else; acc: (nnz,) floats of scratch for the sums between passes (read
// only where d > kSliceCols).  One launch per kSliceCols columns of d, in
// order on the stream.
extern "C" int gather_sddmm_launch(const int* indptr, const int* cols,
                                   const int* pos, const float* x,
                                   const float* yt, float* out, float* acc,
                                   int num_rows, int d, void* stream) {
  if (num_rows == 0 || d == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_ok(x, yt, d)
          ? launch_sddmm_rows<true, kSliceCols, kUnrollLoads, true>(
                indptr, cols, pos, x, yt, out, acc, num_rows, d, st)
          : launch_sddmm_rows<false, kSliceCols, kUnrollLoads, true>(
                indptr, cols, pos, x, yt, out, acc, num_rows, d, st));
}

// The same walk with another slice width (32, 64, 128 or 256 columns),
// unroll depth (4 or 8 loads in flight a lane) and streaming hint (0: the
// index through the read-only path, plain loads and stores of the sums and
// dots), for bench_torch/gather_sweep.py; acc holds nnz floats where d >
// slice.  d a multiple of 4 with x and yt 16-byte aligned, else
// cudaErrorInvalidValue, as for a choice it does not build.
extern "C" int gather_sddmm_variant_launch(const int* indptr, const int* cols,
                                           const int* pos, const float* x,
                                           const float* yt, float* out,
                                           float* acc, int num_rows, int d,
                                           int slice, int unroll,
                                           int streaming, void* stream) {
  if (!vec_ok(x, yt, d)) return cudaErrorInvalidValue;
  if (num_rows == 0 || d == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SDDMM_VARIANT(S, U)                                        \
  if (slice == S && unroll == U)                                         \
    return static_cast<int>(                                             \
        streaming ? launch_sddmm_rows<true, S, U, true>(                 \
                        indptr, cols, pos, x, yt, out, acc, num_rows, d, \
                        st)                                              \
                  : launch_sddmm_rows<true, S, U, false>(                \
                        indptr, cols, pos, x, yt, out, acc, num_rows, d, \
                        st));
  REPRO_SDDMM_VARIANT(32, 4)
  REPRO_SDDMM_VARIANT(32, 8)
  REPRO_SDDMM_VARIANT(64, 4)
  REPRO_SDDMM_VARIANT(64, 8)
  REPRO_SDDMM_VARIANT(128, 4)
  REPRO_SDDMM_VARIANT(128, 8)
  REPRO_SDDMM_VARIANT(256, 4)
  REPRO_SDDMM_VARIANT(256, 8)
#undef REPRO_SDDMM_VARIANT
  return cudaErrorInvalidValue;
}
