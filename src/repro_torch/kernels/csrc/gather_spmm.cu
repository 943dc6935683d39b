// Vector-engine path of NeutronSparse on Hopper: row-sorted COO gather SpMM.
//
// Replaces: the two Pallas TPU fringe kernels of
// repro/kernels/gather_spmm.py,
//   - gather_spmm (tier "resident"): out[rows[i]] += vals[i] * B[cols[i]]
//     over the row-sorted packed fringe COO, with the whole (K, bn) B panel
//     and the packed output held in VMEM;
//   - gather_spmm_ksharded (tier "ksharded"): the same product over the
//     k-bucketed stream, whose columns are local to their k-block
//     (chunk_kb maps chunk -> k-block) so that only a (bk, bn) B slice is
//     in VMEM at a time, partial row sums merging in the resident output.
//
// What bounds it on the H100: each nonzero reads one N-wide fp32 row of B
// (4*N bytes) for 2*N flops: 0.5 flops/byte, far below the fp32 ridge of
// 20 flops/byte.  It is bound by memory traffic; since B rows are gathered
// by column id, the traffic that counts is B rows fetched through L2
// (50 MB) from device memory, not the once-each input bytes.
//
// The TPU kernels need their B panel and output in VMEM; the GPU needs
// neither.  B is read straight from device memory through L2, so K has no
// ceiling and the TPU's VMEM tiers lose their meaning: "resident" and the
// reference's kernel-less "xla" tier both run the row walk.  Rows are
// disjoint between warps: no atomics, and each row's nonzeros are summed
// in a fixed order, so two calls are bit-identical.  A row with no
// nonzeros is written as zeros.  Offsets into B and out are 64-bit.
//
// gather_spmm (gather_rows_kernel): one warp owns one packed output row
// and one column slice of kSliceCols columns (the slice is the grid's
// slowest index, so every block of one slice runs before the next slice
// starts: the B columns the card gathers at any time are that slice's,
// 1/4 of B at N = 256 and 64-column slices, which keeps more of the hot
// set in the 50 MB L2).  The warp reads 32 of the row's (col, val) pairs
// at a time, one per lane (the next 32 are loaded while these are summed),
// and takes them kUnroll at a time by shuffles,
// so each lane has kUnroll B-row float4 loads in flight before the first
// FFMA (the first design issued one pair's eight scalar loads, then its
// FFMAs, then the next pair's: about eight loads in flight a warp).  A
// slice narrower than 128 columns puts 32*4/kSliceCols pairs side by side
// in one warp, each on its own lanes, and adds their partial sums at the
// end in a fixed order.  Lanes read 16 bytes of consecutive columns; N not
// a multiple of 4 (rows not 16-byte aligned) takes the same walk with
// guarded 4-byte loads.  The slice width and the unroll depth were chosen
// on the card by bench_torch/gather_sweep.py (PERF.md);
// gather_spmm_variant_launch runs the other choices for it.
//
// gather_spmm_ksharded runs the same row walk (gather_spmm_perm_launch).
// On the card the k-sharded tier buys nothing: its stream is the same
// product with k-block-local columns.  The wrapper remaps it once, from the
// structure alone, into a stable row-major order `perm` of the stream
// (each row's entries stay in k-block order, the order in which the TPU's
// resident output accumulated them) with global columns chunk_kb[i /
// chunk] * bk + col, cached with the plan.  The values are not cached (a
// value update rewrites them): each call first gathers vals[perm] into
// scratch (gather_vals_kernel, coalesced but for the value reads), then
// walks.  Reading the values through perm inside the walk instead took
// 5.36 ms against 4.83 on the H100, on a reddit-shaped fringe (bench_torch/
// gather_sweep.py, PERF.md): there each value arrives after two dependent
// loads.  Padding entries (row 0, col 0, value 0) are walked as well:
// they add 0 * B[kb * bk], NaN where that row holds an Inf or a NaN, as in
// the TPU kernel; their global column is a real k-block's first, below K,
// so B is read as it is, unpadded.  (The first design, one warp per row
// over a 256-column tile with one B-row load in flight per lane, took
// 10.4 ms on the H100 on the reddit-scale fringe forced onto the tier.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows per block
constexpr unsigned kFull = 0xffffffffu;

// ---- gather_spmm: the row walk -------------------------------------------

// The committed choice (bench_torch/gather_sweep.py on the H100, PERF.md).
constexpr int kDefaultSlice = 64;
constexpr int kDefaultUnroll = 4;

// 4 consecutive floats of a B row at column col (zeros past n, or where
// !ok): one 16-byte load (kVec: n a multiple of 4, rows 16-byte aligned),
// else guarded 4-byte loads.
template <bool kVec>
__device__ __forceinline__ float4 load_b4(const float* brow, int col, int n,
                                          bool ok) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kVec) {
    if (ok && col < n) r = __ldg(reinterpret_cast<const float4*>(brow + col));
  } else {
    if (ok && col < n) r.x = __ldg(brow + col);
    if (ok && col + 1 < n) r.y = __ldg(brow + col + 1);
    if (ok && col + 2 < n) r.z = __ldg(brow + col + 2);
    if (ok && col + 3 < n) r.w = __ldg(brow + col + 3);
  }
  return r;
}

template <bool kVec>
__device__ __forceinline__ void store_b4(float* orow, int col, int n,
                                         float4 v) {
  if constexpr (kVec) {
    if (col < n) *reinterpret_cast<float4*>(orow + col) = v;
  } else {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < n) orow[col + i] = x[i];
  }
}

template <bool kVec, int kSliceCols, int kUnroll>
__global__ void __launch_bounds__(32 * kWarps)
gather_rows_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float* __restrict__ b,
                   float* __restrict__ out,
                   int num_rows, int n) {
  // lanes per pair, pairs side by side, float4s per lane and pair
  constexpr int kLanes = kSliceCols / 4 < 32 ? kSliceCols / 4 : 32;
  constexpr int kGroups = 32 / kLanes;
  constexpr int kVecs = kSliceCols / (4 * kLanes);
  constexpr int kStep = kGroups * kUnroll;  // pairs taken per step
  static_assert(kVecs >= 1 && 32 % kStep == 0, "slice and unroll");

  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= num_rows) return;  // uniform across the warp
  const int grp = lane / kLanes;
  const int c0 = blockIdx.y * kSliceCols + 4 * (lane % kLanes);

  float4 acc[kVecs];
#pragma unroll
  for (int f = 0; f < kVecs; ++f) acc[f] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int beg = indptr[row];
  const int end = indptr[row + 1];
  // the (col, val) pair of each lane, one batch of 32 ahead: its loads
  // are in flight while a batch is summed
  int nx_col = 0;
  float nx_val = 0.f;
  if (beg + lane < end) {
    nx_col = __ldg(cols + beg + lane);
    nx_val = __ldg(vals + beg + lane);
  }
  for (int base = beg; base < end; base += 32) {
    const int my_col = nx_col;
    const float my_val = nx_val;
    const int e = base + 32 + lane;
    if (e < end) {
      nx_col = __ldg(cols + e);
      nx_val = __ldg(vals + e);
    }
    const int cnt = min(32, end - base);
    for (int j0 = 0; j0 < cnt; j0 += kStep) {
      float v[kUnroll];
      float4 bv[kUnroll][kVecs];
      // every B-row load is issued before the values are shuffled
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + kGroups * u + grp;
        const int c = __shfl_sync(kFull, my_col, j);
        const float* brow = b + static_cast<int64_t>(c) * n;
#pragma unroll
        for (int f = 0; f < kVecs; ++f)
          bv[u][f] = load_b4<kVec>(brow, c0 + 4 * kLanes * f, n, j < cnt);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + kGroups * u + grp;
        const float x = __shfl_sync(kFull, my_val, j);
        v[u] = j < cnt ? x : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int f = 0; f < kVecs; ++f) {
          acc[f].x = fmaf(v[u], bv[u][f].x, acc[f].x);
          acc[f].y = fmaf(v[u], bv[u][f].y, acc[f].y);
          acc[f].z = fmaf(v[u], bv[u][f].z, acc[f].z);
          acc[f].w = fmaf(v[u], bv[u][f].w, acc[f].w);
        }
    }
  }
  // the side-by-side pairs' partial sums, added in a fixed order
#pragma unroll
  for (int off = 16; off >= kLanes; off >>= 1)
#pragma unroll
    for (int f = 0; f < kVecs; ++f) {
      acc[f].x += __shfl_down_sync(kFull, acc[f].x, off);
      acc[f].y += __shfl_down_sync(kFull, acc[f].y, off);
      acc[f].z += __shfl_down_sync(kFull, acc[f].z, off);
      acc[f].w += __shfl_down_sync(kFull, acc[f].w, off);
    }
  if (grp == 0) {
    float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
    for (int f = 0; f < kVecs; ++f)
      store_b4<kVec>(orow, c0 + 4 * kLanes * f, n, acc[f]);
  }
}

template <bool kVec, int kSliceCols, int kUnroll>
cudaError_t launch_rows(const int* indptr, const int* cols, const float* vals,
                        const float* b, float* out, int num_rows, int n,
                        cudaStream_t stream) {
  const dim3 grid((num_rows + kWarps - 1) / kWarps,
                  (n + kSliceCols - 1) / kSliceCols);
  gather_rows_kernel<kVec, kSliceCols, kUnroll>
      <<<grid, 32 * kWarps, 0, stream>>>(indptr, cols, vals, b, out,
                                         num_rows, n);
  return cudaGetLastError();
}

// dst[i] = vals[perm[i]] for i < nnz: the k-bucketed stream's values in
// its row-major order.
__global__ void __launch_bounds__(256)
gather_vals_kernel(const int* __restrict__ perm,
                   const float* __restrict__ vals, float* __restrict__ dst,
                   int nnz) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nnz; i += stride)
    dst[i] = __ldg(vals + __ldg(perm + i));
}

bool vec_ok(const float* b, const float* out, int n) {
  return (n & 3) == 0 && (reinterpret_cast<uintptr_t>(b) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
}

// ---- the gather-bandwidth probe ------------------------------------------

__device__ __forceinline__ uint32_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return static_cast<uint32_t>(z ^ (z >> 31));
}

// Reads `reads` B rows of 256 fp32 (1 KB, as B2 reads per nonzero at
// N = 256) at hashed indices below set_rows, a warp per row, 8 rows in
// flight per warp, and writes one sum per thread to sink (so the loads are
// kept).  What it measures is the card's ceiling for B2's access pattern
// when the rows come from L2 (a set that fits) or from device memory.
__global__ void __launch_bounds__(256)
gather_probe_kernel(const float* __restrict__ b, int n, int set_rows,
                    long long reads, uint32_t seed, float* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i0 = 8 * warp; i0 < reads; i0 += 8 * warps) {
    float4 x[8][2];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long i = i0 + u;
      const uint32_t r =
          mix64(static_cast<uint64_t>(i) +
                0x9E3779B97F4A7C15ull * (seed + 1ull)) %
          static_cast<uint32_t>(set_rows);
      const float4* p =
          reinterpret_cast<const float4*>(b + static_cast<int64_t>(r) * n);
      const bool ok = i < reads;
      x[u][0] = ok ? __ldg(p + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[u][1] = ok ? __ldg(p + 32 + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc.x += x[u][h].x;
        acc.y += x[u][h].y;
        acc.z += x[u][h].z;
        acc.w += x[u][h].w;
      }
  }
  sink[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] =
      acc.x + acc.y + acc.z + acc.w;
}

}  // namespace

// indptr: (num_rows+1,) CSR offsets of the row-sorted packed fringe;
// cols, vals: (nnz,); b: (K, n) row-major; out: (num_rows, n), every
// element written.
namespace {

int launch_default(const int* indptr, const int* cols, const float* vals,
                   const float* b, float* out, int num_rows, int n,
                   cudaStream_t stream) {
  if (vec_ok(b, out, n))
    return static_cast<int>(
        launch_rows<true, kDefaultSlice, kDefaultUnroll>(
            indptr, cols, vals, b, out, num_rows, n, stream));
  return static_cast<int>(
      launch_rows<false, kDefaultSlice, kDefaultUnroll>(
          indptr, cols, vals, b, out, num_rows, n, stream));
}

}  // namespace

extern "C" int gather_spmm_launch(const int* indptr, const int* cols,
                                  const float* vals, const float* b,
                                  float* out, int num_rows, int n,
                                  void* stream) {
  if (num_rows == 0 || n == 0) return 0;
  return launch_default(indptr, cols, vals, b, out, num_rows, n,
                        static_cast<cudaStream_t>(stream));
}

// gather_spmm_ksharded: indptr (num_rows+1,) offsets into the row-major
// order perm (nnz,) of the k-bucketed stream; cols (nnz,) the global
// column of entry perm[e] at e, each below K; vals (nnz,) in stream order;
// scratch (nnz,) floats; b: (K, n) row-major; out: (num_rows, n), every
// element written.  Two launches: the gather of the values, the walk.
extern "C" int gather_spmm_perm_launch(const int* indptr, const int* cols,
                                       const int* perm, const float* vals,
                                       float* scratch, int nnz,
                                       const float* b, float* out,
                                       int num_rows, int n, void* stream) {
  if (num_rows == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nnz > 0) {
    const int blocks = (nnz + 255) / 256 < 4096 ? (nnz + 255) / 256 : 4096;
    gather_vals_kernel<<<blocks, 256, 0, st>>>(perm, vals, scratch, nnz);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_default(indptr, cols, scratch, b, out, num_rows, n, st);
}

// The same product with another slice width (16, 32, 64, 128 or 256
// columns) and unroll depth (2, 4 or 8 pairs a group; not 8 at 16
// columns), for bench_torch/gather_sweep.py; n a multiple of 4 with b and
// out 16-byte aligned, else cudaErrorInvalidValue, as for a choice it does
// not build.
extern "C" int gather_spmm_variant_launch(const int* indptr, const int* cols,
                                          const float* vals, const float* b,
                                          float* out, int num_rows, int n,
                                          int slice, int unroll,
                                          void* stream) {
  if (!vec_ok(b, out, n)) return cudaErrorInvalidValue;
  if (num_rows == 0 || n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_GATHER_VARIANT(S, U)                                  \
  if (slice == S && unroll == U)                                    \
    return static_cast<int>(launch_rows<true, S, U>(                \
        indptr, cols, vals, b, out, num_rows, n, st));
  REPRO_GATHER_VARIANT(16, 2)
  REPRO_GATHER_VARIANT(16, 4)
  REPRO_GATHER_VARIANT(32, 2)
  REPRO_GATHER_VARIANT(32, 4)
  REPRO_GATHER_VARIANT(32, 8)
  REPRO_GATHER_VARIANT(64, 2)
  REPRO_GATHER_VARIANT(64, 4)
  REPRO_GATHER_VARIANT(64, 8)
  REPRO_GATHER_VARIANT(128, 2)
  REPRO_GATHER_VARIANT(128, 4)
  REPRO_GATHER_VARIANT(128, 8)
  REPRO_GATHER_VARIANT(256, 2)
  REPRO_GATHER_VARIANT(256, 4)
  REPRO_GATHER_VARIANT(256, 8)
#undef REPRO_GATHER_VARIANT
  return cudaErrorInvalidValue;
}

// The gather-bandwidth probe (gather_probe_kernel): b (>= set_rows, n)
// with n >= 256 a multiple of 4 and b 16-byte aligned; sink: blocks * 256
// floats.  Reached only from chip_smoke.py and bench_torch/gather_sweep.py.
extern "C" int gather_probe_launch(const float* b, int n, int set_rows,
                                   long long reads, int seed, float* sink,
                                   int blocks, void* stream) {
  if (n < 256 || (n & 3) || set_rows <= 0 || blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(b) & 15u))
    return cudaErrorInvalidValue;
  gather_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      b, n, set_rows, reads, static_cast<uint32_t>(seed), sink);
  return static_cast<int>(cudaGetLastError());
}
