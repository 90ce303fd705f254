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
// the chunks that two tiles share in the no-pack layout. Here, as in the
// forward kernel (rasterize.cu), one block owns one tile and one thread one
// pixel:
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
//    atomics: a butterfly of warp shuffles (skipped, with zeros written,
//    when no lane of the warp touched the entry), then the warps' partial
//    sums in shared memory, added in warp order. The same inputs give the
//    same bits on every run.
//  * Every entry of a tile's range is written once: entries that were not
//    applied, chunk padding, and all entries after the tile saturated get
//    explicit zeros. Ranges of different tiles are disjoint in both pack
//    modes, so no write is shared. Slots outside every range are not
//    written, as in the TPU kernel: no caller reads them (their gid is -1).
//
//  * blend_quad="mxu" replays K2's mxu mode (blend_mxu.cuh, the same
//    coefficients and op order): the first warp computes the staged
//    entries' coefficients into shared memory beside their fields. alpha
//    is exp(power'), never op * exp(power), so the opacity gradient is
//    sum_p dL/dalpha alpha, divided once per entry by the opacity where it
//    is > 0 (as the JAX kernel, rasterize_pallas.py:643-644). Every other
//    term, and the reduction, is vpu's.
//
// What bounds it on the card: per (entry, pixel) pair the forward's
// arithmetic and transcendentals plus the gradient terms, and per entry and
// warp the shuffle reduction, i.e. FP32/SFU issue. Device memory traffic is
// the payload read once, the residual read once and the gradients of the
// entries in range written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_mxu.cuh"

namespace {

constexpr int kFields = 9;
constexpr int kMaxPix = 1024;
constexpr int kBatch = 32;  // entries staged per round

template <bool kMxu>
__global__ void __launch_bounds__(kMaxPix)
rasterize_backward_kernel(const float* __restrict__ payload,  // (9, capacity)
                          int64_t capacity,
                          const int32_t* __restrict__ tile_starts,
                          const int32_t* __restrict__ tile_counts,
                          const float* __restrict__ residual,  // (tiles, pix, 8)
                          int grid_x, int width, int height,
                          int tile_w, int tile_h, float alpha_max,
                          float alpha_min, float t_eps, float power_guard,
                          float* __restrict__ grads) {  // (9, capacity)
  __shared__ float stage[kFields][kBatch];
  __shared__ float coef[kMxu ? kMxuCoefs : 1][kBatch];  // mxu only
  extern __shared__ float part[];  // (9, warps, kBatch) per-warp sums
  const int pix = tile_w * tile_h;  // == blockDim.x, a multiple of 32
  const int n_warps = pix >> 5;
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx = (tile % grid_x) * tile_w, ty = (tile / grid_x) * tile_h;
  const int ix = tx + p % tile_w;
  const int iy = ty + p / tile_w;
  const bool inside = ix < width && iy < height;
  const float fx = (float)ix, fy = (float)iy;
  const MxuBasis u = mxu_basis(p, tile_w);  // unused by vpu
  const int64_t start = tile_starts[tile];
  const int count = tile_counts[tile];

  const float* res = residual + ((int64_t)tile * pix + p) * 8;
  const float g_r = res[0], g_g = res[1], g_b = res[2], g_t = res[3];
  // sum over all applied entries of w_k b_k == dot(C_final, G)
  const float cg_total = res[4] * g_r + res[5] * g_g + res[6] * g_b;
  const float tail = res[7] * g_t;  // T_final * dL/dT_final

  float s = 0.0f;       // log-transmittance, as the forward carries it
  float prefix = 0.0f;  // sum_{k<=j} w_k b_k over applied entries
  bool done = !inside;

  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    // barrier + early exit (every pixel done: nothing applies any more);
    // also orders the previous round's reads of stage/part before the
    // writes below
    if (__syncthreads_count(!done) == 0) break;
    const int m = min(kBatch, count - b0);
    for (int i = p; i < kFields * kBatch; i += pix) {
      const int f = i / kBatch, k = i % kBatch;
      if (k < m) stage[f][k] = payload[f * capacity + start + b0 + k];
    }
    if constexpr (kMxu) {
      if (p < m) {
        const float* src = payload + start + b0 + p;
        mxu_coefficients(src[0], src[capacity], src[2 * capacity],
                         src[3 * capacity], src[4 * capacity],
                         src[5 * capacity], (float)tx, (float)ty, power_guard,
                         &coef[0][p], kBatch);
      }
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      float v[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
      bool hit = false;
      if (!done) {
        // the forward's op order (rasterize.cu), for its decisions
        const float dx = __fsub_rn(stage[0][k], fx);
        const float dy = __fsub_rn(stage[1][k], fy);
        bool pow_ok;
        float g, raw;  // vpu: g = exp(power), raw = op g; mxu: raw = exp(power')
        if constexpr (kMxu) {
          const float pw = mxu_power(&coef[0][k], kBatch, u);
          pow_ok = pw <= coef[kMxuCoefs - 1][k];
          g = 0.0f;
          raw = pow_ok ? expf(pw) : 0.0f;
        } else {
          const float qa = __fmul_rn(__fmul_rn(stage[2][k], dx), dx);
          const float qc = __fmul_rn(__fmul_rn(stage[4][k], dy), dy);
          const float power =
              __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                        __fmul_rn(__fmul_rn(stage[3][k], dx), dy));
          pow_ok = power <= 0.0f;
          g = pow_ok ? expf(power) : 0.0f;
          raw = __fmul_rn(stage[5][k], g);
        }
        if (pow_ok) {
          const float alpha = raw > alpha_max ? alpha_max : raw;
          if (alpha >= alpha_min) {
            const float s_new = __fadd_rn(s, log1pf(-alpha));
            const float t_after = expf(s_new);
            if (!(t_after >= t_eps)) {
              done = true;  // stops here without applying, as the forward
            } else {
              const float one_minus = __fsub_rn(1.0f, alpha);
              const float t_before = __fdiv_rn(t_after, one_minus);
              const float w = __fmul_rn(t_before, alpha);
              const float b =
                  stage[6][k] * g_r + stage[7][k] * g_g + stage[8][k] * g_b;
              prefix += w * b;
              const float d_alpha =
                  raw > alpha_max
                      ? 0.0f
                      : t_before * b - (cg_total - prefix + tail) / one_minus;
              const float d_pow = d_alpha * alpha;  // alpha = op * g
              const float ca = stage[2][k], cb = stage[3][k], cc = stage[4][k];
              // power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, dx = mx - px
              v[0] = -d_pow * (ca * dx + cb * dy);
              v[1] = -d_pow * (cc * dy + cb * dx);
              v[2] = -0.5f * d_pow * dx * dx;
              v[3] = -d_pow * dx * dy;
              v[4] = -0.5f * d_pow * dy * dy;
              // mxu: d_alpha alpha here, divided by the opacity below
              v[5] = kMxu ? d_pow : d_alpha * g;
              v[6] = w * g_r;
              v[7] = w * g_g;
              v[8] = w * g_b;
              hit = true;
              s = s_new;
            }
          }
        }
      }
      float* slot = part + warp * kBatch + k;  // + f * n_warps * kBatch
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[f] += __shfl_xor_sync(0xffffffffu, v[f], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < kFields; ++f) slot[f * n_warps * kBatch] = v[f];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) slot[f * n_warps * kBatch] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = p; i < kFields * kBatch; i += pix) {
      const int f = i / kBatch, k = i % kBatch;
      if (k < m) {
        const float* src = part + f * n_warps * kBatch + k;
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
  for (int j = b0 + p; j < count; j += pix) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) grads[f * capacity + start + j] = 0.0f;
  }
}

}  // namespace

// mxu: 0 = blend_quad "vpu", 1 = "mxu"
extern "C" int rasterize_backward_launch(
    const float* payload, int64_t capacity, const int32_t* tile_starts,
    const int32_t* tile_counts, const float* residual, int num_tiles,
    int grid_x, int width, int height, int tile_w, int tile_h, int mxu,
    float alpha_max, float alpha_min, float t_eps, float power_guard,
    float* grads, cudaStream_t stream) {
  const int pix = tile_w * tile_h;
  if (pix % 32 != 0 || pix > kMaxPix) return (int)cudaErrorInvalidValue;
  const size_t part_bytes = sizeof(float) * kFields * (pix / 32) * kBatch;
  auto kernel = mxu ? rasterize_backward_kernel<true>
                    : rasterize_backward_kernel<false>;
  kernel<<<num_tiles, pix, part_bytes, stream>>>(
      payload, capacity, tile_starts, tile_counts, residual, grid_x, width,
      height, tile_w, tile_h, alpha_max, alpha_min, t_eps, power_guard,
      grads);
  return (int)cudaGetLastError();
}
