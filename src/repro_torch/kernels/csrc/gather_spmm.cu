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
// Design: the TPU kernels need their B panel and output in VMEM; the GPU
// needs neither.  One warp owns one packed output row and a 256-column
// n-tile (8 columns per lane, lanes on consecutive columns, so every B-row
// load is a coalesced 128-byte transaction).  The warp reads 32 of the
// row's (col, val) pairs at a time, one per lane, broadcasts them with
// shuffles, and sums the row's nonzeros in order in registers, then writes
// the row once.  Rows are disjoint between warps: no atomics, and a
// deterministic sum.  A row with no nonzeros is written as zeros.  B is
// read straight from device memory through L2, so K has no ceiling and the
// TPU's VMEM tiers lose their meaning: "resident" and the reference's
// kernel-less "xla" tier both run the plain row walk.  For the k-bucketed
// stream the wrapper passes a stable row-major permutation of the stream,
// so each row walks its entries in k-block order (the order in which the
// TPU's resident output accumulated them), and the kernel adds the
// k-block offset chunk_kb[i / chunk] * bk to each local column.  Padding
// entries of that stream (row 0, col 0, value 0) add zero.  Offsets into B
// and out are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // rows per block
constexpr int kLaneCols = 8;        // columns per lane
constexpr int kTileCols = 32 * kLaneCols;  // 256 columns per warp tile
constexpr unsigned kFull = 0xffffffffu;

template <bool kBucketed>
__global__ void __launch_bounds__(32 * kWarps)
gather_spmm_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ perm,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals,
                   const int* __restrict__ chunk_kb,
                   int chunk, int bk,
                   const float* __restrict__ b,
                   float* __restrict__ out,
                   int num_rows, int n) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= num_rows) return;  // uniform across the warp
  const int c0 = blockIdx.y * kTileCols + lane;

  float acc[kLaneCols];
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) acc[q] = 0.f;

  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_val = 0.f;
    if (e < end) {
      const int i = kBucketed ? perm[e] : e;
      my_val = vals[i];
      my_col = cols[i];
      if (kBucketed) my_col += chunk_kb[i / chunk] * bk;
    }
    const int cnt = min(32, end - base);
    for (int j = 0; j < cnt; ++j) {
      const int c = __shfl_sync(kFull, my_col, j);
      const float v = __shfl_sync(kFull, my_val, j);
      const float* brow = b + static_cast<int64_t>(c) * n;
#pragma unroll
      for (int q = 0; q < kLaneCols; ++q) {
        const int col = c0 + 32 * q;
        if (col < n) acc[q] = fmaf(v, brow[col], acc[q]);
      }
    }
  }

  float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
  for (int q = 0; q < kLaneCols; ++q) {
    const int col = c0 + 32 * q;
    if (col < n) orow[col] = acc[q];
  }
}

dim3 grid_for(int num_rows, int n) {
  return dim3((num_rows + kWarps - 1) / kWarps,
              (n + kTileCols - 1) / kTileCols);
}

}  // namespace

// indptr: (num_rows+1,) CSR offsets of the row-sorted packed fringe;
// cols, vals: (nnz,); b: (K, n) row-major; out: (num_rows, n), every
// element written.
extern "C" int gather_spmm_launch(const int* indptr, const int* cols,
                                  const float* vals, const float* b,
                                  float* out, int num_rows, int n,
                                  void* stream) {
  if (num_rows == 0 || n == 0) return 0;
  gather_spmm_kernel<false><<<grid_for(num_rows, n), 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      indptr, nullptr, cols, vals, nullptr, 1, 0, b, out, num_rows, n);
  return static_cast<int>(cudaGetLastError());
}

// perm: (nnz,) stable row-major order of the k-bucketed stream; indptr:
// (num_rows+1,) offsets into perm; cols: k-block-local columns; chunk_kb:
// (nnz/chunk,) k-block of each chunk; b: (K_pad, n), K_pad a multiple of bk.
extern "C" int gather_spmm_ksharded_launch(const int* indptr, const int* perm,
                                           const int* cols, const float* vals,
                                           const int* chunk_kb, int chunk,
                                           int bk, const float* b, float* out,
                                           int num_rows, int n,
                                           void* stream) {
  if (num_rows == 0 || n == 0) return 0;
  gather_spmm_kernel<true><<<grid_for(num_rows, n), 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      indptr, perm, cols, vals, chunk_kb, chunk, bk, b, out, num_rows, n);
  return static_cast<int>(cudaGetLastError());
}
