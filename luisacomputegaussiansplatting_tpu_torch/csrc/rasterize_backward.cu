// Backward tile rasterizer: the gradient of every payload field of every
// entry, from the per-pixel residual [dL/dC rgb, dL/dT, C_final rgb,
// T_final] of the forward blend.
//
// Replaces the TPU kernel luisacomputegaussiansplatting_tpu/ops/
// rasterize_pallas.py `_backward_kernel` (launched by `rasterize_backward`,
// the backward of the custom VJP `rasterize_tiles`), in both of its modes,
// blend_quad="vpu" and "mxu" (a template parameter here). The
// TPU version replays (pixels x 128-entry chunks) as dense tiles with MXU
// prefix sums and a tile-local moment contraction, and read-modify-writes
// the chunks that two tiles share in the no-pack layout. Here one block owns
// one tile, and each thread P of its pixels (P = 1, 2 or 4, a template
// parameter the wrapper picks from the tile: pixels t, t + threads, ...):
//
//  * Each pixel replays the forward exactly: the same sequential log-sum
//    s += log1p(-alpha), T = exp(s), in the same round-to-nearest op order as
//    rasterize.cu, so "applied" and "stopped" are the forward's own
//    decisions, entry for entry.
//  * The weight of the entries behind entry j comes from the suffix identity
//    of the TPU kernel: suffix_j = dot(C_final, G) - sum_{k<=j} w_k b_k, with
//    b_k = dot(rgb_k, G) and G = dL/dC, so one front-to-back pass suffices:
//      dL/dalpha_j = T_before_j b_j - (suffix_j + T_final dL/dT) / (1 - alpha_j).
//    It is zero where alpha was clamped at alpha_max, and the direct
//    per-pixel chain rule gives the nine field gradients (dL/dopacity as
//    sum dL/dalpha exp(power), safe at opacity -> 0).
//  * Each entry's nine per-pixel values are summed over the tile without
//    atomics: a thread first adds its P pixels' values in registers, then
//    the warp runs one reduce-scatter of the nine sums (12 shuffles, lane
//    pair 2f..2f+1 ends with field f's total; skipped, with zeros written,
//    when no lane of the warp touched the entry), then every thread of the
//    block adds the warps' partial sums of one (field, entry) in warp
//    order. The same inputs give the same bits on every run.
//  * Every entry of a tile's range is written once: entries that were not
//    applied, chunk padding, and all entries after the tile saturated get
//    explicit zeros. Ranges of different tiles are disjoint in both pack
//    modes, so no write is shared. Slots outside every range are not
//    written, as in the TPU kernel: no caller reads them (their gid is -1).
//
//  * blend_quad="mxu" replays K2's mxu mode (blend_mxu.cuh, the same
//    coefficients and op order): the block computes the staged entries'
//    coefficients into shared memory beside their fields. alpha is
//    exp(power'), never op * exp(power), so the opacity gradient is
//    sum_p dL/dalpha alpha, divided once per entry by the opacity where it
//    is > 0 (as the JAX kernel, rasterize_pallas.py:643-644). Every other
//    term, and the reduction, is vpu's.
//
// What bounds it on the card: the work is per (entry, pixel) pair the
// forward's arithmetic and transcendentals plus the gradient terms, and per
// entry and warp the reduction; device memory traffic is only the payload
// and the residual read once and the gradients of the entries in range
// written once. Its applied path (log1pf, expf, the stop test) is a serial
// chain per pixel that diverges across a warp, so it is bound by latency
// more than by FP32 throughput, and what fits on an SM counts. With one thread
// per pixel a 32x32 tile would be one 1024-thread block filling an SM
// (every barrier stalling all of it), and a warp would reduce each entry
// with nine butterflies, 45 shuffles for 32 pixels. So: P pixels per thread
// cut the reductions per pixel by P, the reduce-scatter cuts the shuffles
// per reduction to 12, 64-entry batches keep the barriers per entry low,
// the per-pixel residual terms live in shared memory and the launch bounds
// cap the registers (85 at P = 4: three 256-thread blocks an SM at tile 32;
// 64 at P = 2: eight 128-thread blocks at tile 16) with no spills, and the
// two divisions that feed only the gradient share one approximate
// reciprocal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_mxu.cuh"

namespace {

constexpr int kFields = 9;
constexpr int kMaxPix = 1024;
constexpr int kBatch = 64;  // entries staged per round
constexpr unsigned kFull = 0xffffffffu;

// One step of the warp's reduce-scatter: a lane holds 2K partial sums (the
// last ones may be padding zeros); it keeps the upper K where lane & Off is
// set and the lower K where it is not, each added to the partner lane's
// value of the same field.
template <int K, int Off>
__device__ __forceinline__ void scatter_step(const float (&v)[2 * K],
                                             float (&w)[K], bool upper) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[K + i];
    const float keep = upper ? v[K + i] : v[i];
    w[i] = keep + __shfl_xor_sync(kFull, send, Off);
  }
}

// The warp's totals of the nine values: 9 -> 5 -> 3 -> 2 -> 1 sums a lane
// (offsets 16, 8, 4, 2), then the pair (lane, lane ^ 1) adds its two
// partials; 5 + 3 + 2 + 1 + 1 = 12 shuffles. Lane `lane` returns the total
// of field scatter_field(lane), where that is >= 0.
__device__ __forceinline__ float warp_sum_scatter(const float (&v)[kFields],
                                                  int lane) {
  const float a[10] = {v[0], v[1], v[2], v[3], v[4],
                       v[5], v[6], v[7], v[8], 0.0f};
  float b[5];
  scatter_step<5, 16>(a, b, lane & 16);
  const float b6[6] = {b[0], b[1], b[2], b[3], b[4], 0.0f};
  float c[3];
  scatter_step<3, 8>(b6, c, lane & 8);
  const float c4[4] = {c[0], c[1], c[2], 0.0f};
  float d[2];
  scatter_step<2, 4>(c4, d, lane & 4);
  float e[1];
  scatter_step<1, 2>(d, e, lane & 2);
  return e[0] + __shfl_xor_sync(kFull, e[0], 1);
}

// The field whose total warp_sum_scatter leaves in an even lane, or -1
// (odd lanes hold a copy; some even lanes hold only padding). A lane's
// sums are the fields [base, base + len) of its array, then padding.
__device__ __forceinline__ int scatter_field(int lane) {
  if (lane & 1) return -1;
  constexpr int kKeep[4] = {5, 3, 2, 1};  // sums kept at offsets 16, 8, 4, 2
  int base = 0, len = kFields;
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    if (lane & (16 >> step)) {
      base += kKeep[step];
      len -= kKeep[step];
    } else if (len > kKeep[step]) {
      len = kKeep[step];
    }
  }
  return len >= 1 ? base : -1;
}

template <bool kMxu, int P>
__global__ void __launch_bounds__(kMaxPix / P, P == 4 ? 3 : P)
rasterize_backward_kernel(const float* __restrict__ payload,  // (9, capacity)
                          int64_t capacity,
                          const int32_t* __restrict__ tile_starts,
                          const int32_t* __restrict__ tile_counts,
                          const float* __restrict__ residual,  // (tiles, pix, 8)
                          int grid_x, int tile_offset, int width, int height,
                          int tile_w, int tile_h, float alpha_max,
                          float alpha_min, float t_eps, float power_guard,
                          float* __restrict__ grads) {  // (9, capacity)
  __shared__ float stage[kFields][kBatch];
  __shared__ float coef[kMxu ? kMxuCoefs : 1][kBatch];  // mxu only
  // per-warp sums [field][warp][entry] (the field stride is padded by one
  // so that the nine lanes storing one entry's fields hit nine banks), then
  // the per-pixel residual terms [5][pixels]
  extern __shared__ float part[];
  const int n_threads = blockDim.x;  // pixels / P, a multiple of 32
  const int n_warps = n_threads >> 5;
  const int fstride = n_warps * kBatch + 1;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int my_field = scatter_field(lane);
  const int tile = blockIdx.x;
  // the tile's place in the whole frame, as in the forward blend
  const int gtile = tile_offset + tile;
  const int tx = (gtile % grid_x) * tile_w, ty = (gtile / grid_x) * tile_h;
  const int64_t start = tile_starts[tile];
  const int count = tile_counts[tile];

  // this thread's pixels t + i * n_threads: coordinates and the forward's
  // state in registers; the residual terms, read only by applied pairs, in
  // shared memory (registers bound how many blocks share an SM)
  const int pix = n_threads * P;
  // [0..2] dL/dC rgb, [3] dot(C_final, G) == sum over all applied entries
  // of w_k b_k, [4] T_final * dL/dT_final
  float* res_terms = part + kFields * fstride;
  float fx[P], fy[P];  // vpu
  MxuBasis u[P];       // mxu
  float s[P];         // log-transmittance, as the forward carries it
  float prefix[P];    // sum_{k<=j} w_k b_k over applied entries
  unsigned done = 0;  // bit i: pixel i is outside the image or has stopped
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = t + i * n_threads;
    const int ix = tx + p % tile_w;
    const int iy = ty + p / tile_w;
    if (!(ix < width && iy < height)) done |= 1u << i;
    fx[i] = (float)ix;
    fy[i] = (float)iy;
    u[i] = mxu_basis(p, tile_w);  // unused by vpu
    const float* res = residual + ((int64_t)tile * pix + p) * 8;
    res_terms[p] = res[0];
    res_terms[pix + p] = res[1];
    res_terms[2 * pix + p] = res[2];
    res_terms[3 * pix + p] = res[4] * res[0] + res[5] * res[1] + res[6] * res[2];
    res_terms[4 * pix + p] = res[7] * res[3];
    s[i] = 0.0f;
    prefix[i] = 0.0f;
  }
  constexpr unsigned kAllDone = (1u << P) - 1;

  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    // barrier + early exit (every pixel done: nothing applies any more);
    // also orders the previous round's reads of stage/part before the
    // writes below
    if (__syncthreads_count(done != kAllDone) == 0) break;
    const int m = min(kBatch, count - b0);
    for (int i = t; i < kFields * kBatch; i += n_threads) {
      const int f = i / kBatch, k = i % kBatch;
      if (k < m) stage[f][k] = payload[f * capacity + start + b0 + k];
    }
    if constexpr (kMxu) {
      for (int e = t; e < m; e += n_threads) {
        const float* src = payload + start + b0 + e;
        mxu_coefficients(src[0], src[capacity], src[2 * capacity],
                         src[3 * capacity], src[4 * capacity],
                         src[5 * capacity], (float)tx, (float)ty, power_guard,
                         &coef[0][e], kBatch);
      }
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float mx = stage[0][k], my = stage[1][k];
      const float ca = stage[2][k], cb = stage[3][k], cc = stage[4][k];
      const float op = stage[5][k];
      const float cr = stage[6][k], cgr = stage[7][k], cbl = stage[8][k];
      float c[kMxuCoefs];
      if constexpr (kMxu) {
#pragma unroll
        for (int j = 0; j < kMxuCoefs; ++j) c[j] = coef[j][k];
      }
      float v[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
      bool hit = false;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (done & (1u << i)) continue;
        // the forward's op order (rasterize.cu), for its decisions
        const float dx = __fsub_rn(mx, fx[i]);
        const float dy = __fsub_rn(my, fy[i]);
        bool pow_ok;
        float g, raw;  // vpu: g = exp(power), raw = op g; mxu: raw = exp(power')
        if constexpr (kMxu) {
          const float pw = mxu_power(c, 1, u[i]);
          pow_ok = pw <= c[kMxuCoefs - 1];
          g = 0.0f;
          raw = pow_ok ? expf(pw) : 0.0f;
        } else {
          const float qa = __fmul_rn(__fmul_rn(ca, dx), dx);
          const float qc = __fmul_rn(__fmul_rn(cc, dy), dy);
          const float power =
              __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                        __fmul_rn(__fmul_rn(cb, dx), dy));
          pow_ok = power <= 0.0f;
          g = pow_ok ? expf(power) : 0.0f;
          raw = __fmul_rn(op, g);
        }
        if (!pow_ok) continue;
        const float alpha = raw > alpha_max ? alpha_max : raw;
        if (!(alpha >= alpha_min)) continue;
        const float s_new = __fadd_rn(s[i], log1pf(-alpha));
        const float t_after = expf(s_new);
        if (!(t_after >= t_eps)) {
          done |= 1u << i;  // stops here without applying, as the forward
          continue;
        }
        // 1 - alpha >= 1 - alpha_max: one approximate reciprocal serves
        // both divisions, which feed only the gradient, never a decision
        const float inv = __fdividef(1.0f, __fsub_rn(1.0f, alpha));
        const float t_before = t_after * inv;
        const float w = __fmul_rn(t_before, alpha);
        const float* rt = res_terms + t + i * n_threads;
        const float g_r = rt[0], g_g = rt[pix], g_b = rt[2 * pix];
        const float b = cr * g_r + cgr * g_g + cbl * g_b;
        prefix[i] += w * b;
        const float d_alpha =
            raw > alpha_max
                ? 0.0f
                : t_before * b - (rt[3 * pix] - prefix[i] + rt[4 * pix]) * inv;
        const float d_pow = d_alpha * alpha;  // alpha = op * g
        // power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, dx = mx - px
        v[0] += -d_pow * (ca * dx + cb * dy);
        v[1] += -d_pow * (cc * dy + cb * dx);
        v[2] += -0.5f * d_pow * dx * dx;
        v[3] += -d_pow * dx * dy;
        v[4] += -0.5f * d_pow * dy * dy;
        // mxu: d_alpha alpha here, divided by the opacity below
        v[5] += kMxu ? d_pow : d_alpha * g;
        v[6] += w * g_r;
        v[7] += w * g_g;
        v[8] += w * g_b;
        hit = true;
        s[i] = s_new;
      }
      float* slot = part + warp * kBatch + k;  // + field * fstride
      if (__any_sync(kFull, hit)) {
        const float sum = warp_sum_scatter(v, lane);
        if (my_field >= 0) slot[my_field * fstride] = sum;
      } else if (my_field >= 0) {
        slot[my_field * fstride] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = t; i < kFields * kBatch; i += n_threads) {
      const int f = i / kBatch, k = i % kBatch;
      if (k < m) {
        const float* src = part + f * fstride + k;
        float acc = 0.0f;
        for (int w = 0; w < n_warps; ++w) acc += src[w * kBatch];
        if (kMxu && f == 5) {
          const float op = stage[5][k];
          acc = op > 0.0f ? __fdiv_rn(acc, op) : 0.0f;
        }
        grads[f * capacity + start + b0 + k] = acc;
      }
    }
  }
  // the tile saturated before its range ended: zeros for the rest
  for (int j = b0 + t; j < count; j += n_threads) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) grads[f * capacity + start + j] = 0.0f;
  }
}

using BackwardKernel = void (*)(const float*, int64_t, const int32_t*,
                                const int32_t*, const float*, int, int, int,
                                int, int, int, float, float, float, float,
                                float*);

template <bool kMxu>
BackwardKernel pick_kernel(int pix_per_thread) {
  switch (pix_per_thread) {
    case 1: return rasterize_backward_kernel<kMxu, 1>;
    case 2: return rasterize_backward_kernel<kMxu, 2>;
    case 4: return rasterize_backward_kernel<kMxu, 4>;
    default: return nullptr;
  }
}

}  // namespace

// mxu: 0 = blend_quad "vpu", 1 = "mxu"; pix_per_thread: 1, 2 or 4, with
// tile_w * tile_h a multiple of 32 * pix_per_thread and at most 1024;
// local tile i lies at global tile tile_offset + i of the grid_x-wide grid
extern "C" int rasterize_backward_launch(
    const float* payload, int64_t capacity, const int32_t* tile_starts,
    const int32_t* tile_counts, const float* residual, int num_tiles,
    int grid_x, int tile_offset, int width, int height, int tile_w,
    int tile_h,
    int pix_per_thread, int mxu, float alpha_max, float alpha_min,
    float t_eps, float power_guard, float* grads, cudaStream_t stream) {
  const int pix = tile_w * tile_h;
  const BackwardKernel kernel = mxu ? pick_kernel<true>(pix_per_thread)
                                    : pick_kernel<false>(pix_per_thread);
  if (kernel == nullptr || pix <= 0 || pix > kMaxPix || tile_offset < 0 ||
      pix % (32 * pix_per_thread) != 0)
    return (int)cudaErrorInvalidValue;
  const int threads = pix / pix_per_thread;
  const size_t dyn_bytes =
      sizeof(float) * (kFields * ((threads / 32) * kBatch + 1) + 5 * pix);
  if (dyn_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<num_tiles, threads, dyn_bytes, stream>>>(
      payload, capacity, tile_starts, tile_counts, residual, grid_x,
      tile_offset, width, height, tile_w, tile_h, alpha_max, alpha_min, t_eps,
      power_guard, grads);
  return (int)cudaGetLastError();
}
