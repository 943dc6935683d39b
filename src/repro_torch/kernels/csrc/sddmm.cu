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
//     in VMEM and one dot per lane of a 128-lane output row.
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
//     that counts is the rows fetched through the 50 MB L2 from device
//     memory, not the once-each input bytes.
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
//   - gather_sddmm: one warp per nonzero reads both rows with coalesced
//     float4 loads (a scalar loop where D is not a multiple of 4 or a row
//     is not 16-byte aligned), each lane sums its elements in order and a
//     butterfly shuffle reduction in a fixed order finishes the dot; lane 0
//     writes it once.  The TPU's "both panels resident" premise does not
//     hold in 227 KB of shared memory and is not needed: rows come through
//     L2, so the panels have no size ceiling (the H100 SDDMM tier rule).

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

constexpr int kWarps = 8;  // nonzeros per block, one per warp

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
