// Sorted segment-sum: out[g] = sum of the rows whose id is g, for rows that
// arrive sorted by id (the per-entry payload gradients reduced into
// per-gaussian gradients).
//
// Replaces the TPU kernels luisacomputegaussiansplatting_tpu/ops/segsum.py
// `_segsum_kernel` (f32 rows) and `_segsum_kernel_packed` (rows rounded to
// bf16 before the add). The TPU version streams id windows through VMEM and
// contracts one-hot (128 ids x entries) strips on the MXU, because it has no
// cheap per-element indexing; its bf16 variant packs two bf16 values per
// int32 to halve the bytes it moves. The bf16 variant here rounds each value
// in registers (round to nearest even), so the rows stay f32 in memory and
// no packing is needed.
//
// What bounds it on the card: device memory, once each id's range is known.
// The rows are read once and the sums written once; the sorted keys fit in
// L2 (3.9M int32 ids are 15.6 MB of its 50 MB). Finding each id's range by
// binary search would cost ~22 dependent L2 round trips per id for ~1.7
// rows per id to sum (the production frame), a time that follows the number
// of ids, not the rows. So two passes find the ranges from the rows:
//
//  * segsum_starts: one thread per sorted row r compares its id with its
//    predecessor's and writes starts[g] = r for every id g in (previous id,
//    its id] clipped to [0, n_out] (row 0 opens from -inf, row L closes to
//    +inf), so starts[g] is the first row whose id is >= g: the lower bound
//    of g, and ids with no rows get starts[g] == starts[g+1]. Every starts
//    slot is written exactly once. Reads and writes are coalesced, O(L +
//    n_out); a gap of more than 32 ids (an empty stretch, the ends) is
//    written by the whole warp.
//  * segsum_sums: one thread per output id sums its rows [starts[g],
//    starts[g+1]) in row order, the columns in registers. Neighbouring
//    threads read neighbouring rows, and each field of the field-major view
//    the backward passes is contiguous, so the reads coalesce. A segment of
//    more than kLongSegment rows (a gaussian over many tiles) is summed by
//    the whole warp instead: lane l takes rows l, l+32, ... in order, then a
//    fixed butterfly. The block writes its (ids, cols) tile through shared
//    memory, coalesced.
//
// Determinism: no atomics; every sum is taken in a fixed order, so the same
// inputs give the same bits on every run.
//
// Ids: rows whose id is < 0 sort first and rows whose id is >= n_out sort
// last, outside [starts[0], starts[n_out]); they are never read (garbage,
// NaN included, cannot leak in). An id with no rows gets zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kLongSegment = 32;  // longer segments are summed by a warp
constexpr int kLongGap = 32;      // longer runs of starts written by a warp

__global__ void __launch_bounds__(kThreads)
segsum_starts_kernel(const int32_t* __restrict__ keys, int64_t n_rows,
                     int64_t n_out, int32_t* __restrict__ starts) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // ids g in [lo, hi] take starts[g] = r
  int64_t lo = 0, hi = -1;
  if (r <= n_rows) {
    const int64_t prev = r == 0 ? INT64_MIN / 2 : (int64_t)keys[r - 1];
    const int64_t cur = r == n_rows ? INT64_MAX / 2 : (int64_t)keys[r];
    lo = prev + 1 > 0 ? prev + 1 : 0;
    hi = cur < n_out ? cur : n_out;
  }
  const bool long_gap = hi - lo + 1 > kLongGap;
  if (!long_gap) {
    for (int64_t g = lo; g <= hi; ++g) starts[g] = (int32_t)r;
  }
  // the warp writes each long gap of its lanes, one after the other
  unsigned todo = __ballot_sync(0xffffffffu, long_gap);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t g0 = __shfl_sync(0xffffffffu, (long long)lo, src);
    const int64_t g1 = __shfl_sync(0xffffffffu, (long long)hi, src);
    const int64_t row = __shfl_sync(0xffffffffu, (long long)r, src);
    for (int64_t g = g0 + lane; g <= g1; g += 32) starts[g] = (int32_t)row;
  }
}

template <bool kRoundBf16>
__device__ __forceinline__ float load_value(const float* p) {
  const float v = *p;
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
segsum_sums_kernel(const int32_t* __restrict__ starts,
                   const float* __restrict__ rows, int64_t row_stride,
                   int64_t col_stride, int cols, int64_t n_out,
                   float* __restrict__ out) {  // (n_out, cols)
  __shared__ float tile[kThreads * kMaxCols];
  const int lane = threadIdx.x & 31;
  const int64_t id0 = (int64_t)blockIdx.x * kThreads;
  const int64_t id = id0 + threadIdx.x;
  int64_t lo = 0, hi = 0;
  if (id < n_out) {
    lo = starts[id];
    hi = starts[id + 1];
  }
  const bool long_seg = hi - lo > kLongSegment;

  float acc[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.0f;
  if (!long_seg) {
    for (int64_t r = lo; r < hi; ++r) {
      const float* row = rows + r * row_stride;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < cols) acc[c] += load_value<kRoundBf16>(row + c * col_stride);
      }
    }
  }
  // the warp sums each long segment of its lanes, one after the other
  unsigned todo = __ballot_sync(0xffffffffu, long_seg);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t r0 = __shfl_sync(0xffffffffu, (long long)lo, src);
    const int64_t r1 = __shfl_sync(0xffffffffu, (long long)hi, src);
    float part[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) part[c] = 0.0f;
    for (int64_t r = r0 + lane; r < r1; r += 32) {
      const float* row = rows + r * row_stride;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < cols) part[c] += load_value<kRoundBf16>(row + c * col_stride);
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < cols) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
        if (lane == src) acc[c] = part[c];
      }
    }
  }

  // the block's (ids, cols) tile, written out contiguously
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < cols) tile[threadIdx.x * cols + c] = acc[c];
  }
  __syncthreads();
  const int64_t left = n_out - id0;
  const int n_ids = left < kThreads ? (int)left : kThreads;
  float* dst = out + id0 * cols;
  for (int i = threadIdx.x; i < n_ids * cols; i += kThreads) dst[i] = tile[i];
}

}  // namespace

// Pass 1: starts (n_out + 1,) int32 of ascending keys (n_rows,) int32.
extern "C" int segsum_starts_launch(const int32_t* keys, int64_t n_rows,
                                    int64_t n_out, int32_t* starts,
                                    cudaStream_t stream) {
  if (n_rows < 0 || n_out < 0 || n_rows > INT32_MAX || n_out >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_rows + 1 + kThreads - 1) / kThreads;
  segsum_starts_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      keys, n_rows, n_out, starts);
  return (int)cudaGetLastError();
}

// Pass 2: out (n_out, cols) float32 from the starts of pass 1 and the rows
// (element [r, c] at rows[r * row_stride + c * col_stride]).
extern "C" int segsum_sums_launch(const int32_t* starts, const float* rows,
                                  int64_t row_stride, int64_t col_stride,
                                  int cols, int64_t n_out, int round_bf16,
                                  float* out, cudaStream_t stream) {
  if (cols < 1 || cols > kMaxCols || n_out < 0 || n_out >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (round_bf16) {
    segsum_sums_kernel<true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        starts, rows, row_stride, col_stride, cols, n_out, out);
  } else {
    segsum_sums_kernel<false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        starts, rows, row_stride, col_stride, cols, n_out, out);
  }
  return (int)cudaGetLastError();
}
