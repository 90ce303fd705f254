// Sorted segment-sum: out[g] = sum of the rows whose id is g, for rows that
// arrive sorted by id (the per-entry payload gradients reduced into
// per-gaussian gradients).
//
// Replaces the TPU kernels luisacomputegaussiansplatting_tpu/ops/segsum.py
// `_segsum_kernel` (f32 rows) and `_segsum_kernel_packed` (rows rounded to
// bf16 before the add). The TPU version streams id windows through VMEM and
// contracts one-hot (128 ids x entries) strips on the MXU, because it has no
// cheap per-element indexing; its bf16 variant packs two bf16 values per
// int32 to halve the bytes it moves. Here one warp owns one output id: it
// finds the id's range in the sorted keys and sums the range's rows. The
// bf16 variant rounds each value in registers (round to nearest even), so
// the rows stay f32 in memory and no packing is needed.
//
// What bounds it on the card: device memory. Each row is read once and each
// output row written once; the two binary searches per id hit the upper
// levels of the key array, which stay in L2.
//
// Determinism: no atomics. Each lane sums its rows in index order and the
// warp combines the 32 partial sums with a fixed butterfly, so the same
// inputs give the same bits on every run.
//
// Ids: rows whose id is < 0 sort first and rows whose id is >= n_out sort
// last; no warp's range ever covers them, so they are never read (garbage,
// NaN included, cannot leak in). An id with no rows gets zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kWarpsPerBlock = 8;

// first index in keys[0, n) whose key is >= v
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ keys,
                                               int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kRoundBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segsum_kernel(const int32_t* __restrict__ keys, int64_t n_rows,
              const float* __restrict__ rows, int64_t row_stride,
              int64_t col_stride, int cols, int64_t n_out,
              float* __restrict__ out) {  // (n_out, cols)
  const int lane = threadIdx.x & 31;
  const int64_t id = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (id >= n_out) return;  // the whole warp leaves together

  // lanes 0 and 1 search the two ends of the id's range at once
  long long bound = 0;
  if (lane < 2) bound = lower_bound(keys, n_rows, id + lane);
  const int64_t lo = __shfl_sync(0xffffffffu, bound, 0);
  const int64_t hi = __shfl_sync(0xffffffffu, bound, 1);

  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
  for (int64_t r = lo + lane; r < hi; r += 32) {
    const float* row = rows + r * row_stride;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < cols) {
        float v = row[c * col_stride];
        if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
        acc[c] += v;
      }
    }
  }
  float mine = 0.0f;  // lane c keeps the total of column c
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < cols) {
      float v = acc[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == c) mine = v;
    }
  }
  if (lane < cols) out[id * cols + lane] = mine;
}

}  // namespace

extern "C" int segsum_launch(const int32_t* keys, int64_t n_rows,
                             const float* rows, int64_t row_stride,
                             int64_t col_stride, int cols, int64_t n_out,
                             int round_bf16, float* out,
                             cudaStream_t stream) {
  if (cols < 1 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const int64_t blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (round_bf16) {
    segsum_kernel<true><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        keys, n_rows, rows, row_stride, col_stride, cols, n_out, out);
  } else {
    segsum_kernel<false><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        keys, n_rows, rows, row_stride, col_stride, cols, n_out, out);
  }
  return (int)cudaGetLastError();
}
