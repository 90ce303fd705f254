// Forward tile rasterizer: front-to-back alpha blending of each tile's
// (tile, depth)-sorted splat entries.
//
// Replaces the TPU kernel luisacomputegaussiansplatting_tpu/ops/
// rasterize_pallas.py `_forward_kernel` (launched by `rasterize_forward`,
// wrapped by the custom VJP `rasterize_tiles`), in both of its modes,
// blend_quad="vpu" and "mxu" (a template parameter here). The TPU
// version blends (pixels x 128-entry chunks) as dense tiles with an MXU
// prefix-sum matmul because it has no per-pixel threads; here the reference's
// own structure comes back (lcgs/src/gs_tile_splatter/shader.cpp:167-289):
// one block per tile, one thread per pixel, entries staged through shared
// memory and blended sequentially.
//
// What bounds it on the card: per (entry, pixel) pair the arithmetic and the
// transcendentals (two expf and a log1pf per live pair, one division), i.e.
// the SM's FP32/SFU issue rate. Device memory traffic is small: each entry's
// 36-byte record is read once per tile and shared by all of its pixels.
//
// Design:
//  * A batch of blockDim entries (9 fields each) is staged into shared memory
//    by the whole block with coalesced field-major reads, then every pixel
//    thread walks the batch in order.
//  * Transmittance is carried as the log-sum S = sum log1p(-alpha), and
//    T = exp(S), which is exactly how the plain PyTorch version
//    (ops/rasterize_ref.py) scans, with the same op order and explicit
//    round-to-nearest intrinsics: the stop decision and T then agree with it
//    up to the plain version's own summation order, not only within a
//    tolerance.
//  * The stop is sticky: a pixel is done at the first entry whose T would
//    fall below eps and never applies another. Pixels past the image edge
//    start done with T = 0 but keep taking part in every barrier; the tile
//    exits early through a block-wide vote (__syncthreads_count), never a
//    per-thread return before a barrier.
//  * One kernel serves both pack modes: it reads [start, start + count);
//    "chunk" padding entries carry opacity 0 and never pass alpha_min.
//  * blend_quad="mxu" (blend_mxu.cuh): the thread that stages entry k
//    computes its six polynomial coefficients and its guard limit
//    ln(opacity) + POWER_GUARD, so shared memory holds 10 floats an entry
//    (7 and the colours) in place of 9; each pixel thread keeps its
//    tile-local basis in registers and evaluates power' with 5 multiplies
//    and 5 adds, one multiply fewer than vpu's power and op * g. The TPU's
//    MXU contraction is gone: the pair's work is plain FP32, still bound by
//    FP32/SFU throughput (tensor cores would be a later design).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_mxu.cuh"

namespace {

constexpr int kFields = 9;
constexpr int kMaxPix = 1024;

template <bool kMxu>
__global__ void __launch_bounds__(kMaxPix)
rasterize_forward_kernel(const float* __restrict__ payload,  // (9, capacity)
                         int64_t capacity,
                         const int32_t* __restrict__ tile_starts,
                         const int32_t* __restrict__ tile_counts, int grid_x,
                         int width, int height, int tile_w, int tile_h,
                         float alpha_max, float alpha_min, float t_eps,
                         float power_guard,
                         float* __restrict__ out_color,  // (tiles, pix, 3)
                         float* __restrict__ out_t) {    // (tiles, pix, 1)
  // vpu: the 9 payload fields; mxu: the coefficients, then r, g, b
  constexpr int kRows = kMxu ? kMxuCoefs + 3 : kFields;
  constexpr int kRgb = kRows - 3;
  __shared__ float stage[kRows][kMaxPix];
  const int pix = tile_w * tile_h;  // == blockDim.x
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = (tile % grid_x) * tile_w, ty = (tile / grid_x) * tile_h;
  const int ix = tx + p % tile_w;
  const int iy = ty + p / tile_w;
  const bool inside = ix < width && iy < height;
  const float fx = (float)ix, fy = (float)iy;
  const MxuBasis u = mxu_basis(p, tile_w);  // unused by vpu
  const int64_t start = tile_starts[tile];
  const int count = tile_counts[tile];

  float s = 0.0f;                  // log-transmittance of the chain
  float t = inside ? 1.0f : 0.0f;  // transmittance after the last applied
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += pix) {
    // barrier + early exit: also orders the previous batch's reads before
    // this batch's writes to shared memory
    if (__syncthreads_count(!done) == 0) break;
    const int j = b0 + p;
    if (j < count) {
      const float* src = payload + start + j;
      if constexpr (kMxu) {
        mxu_coefficients(src[0], src[capacity], src[2 * capacity],
                         src[3 * capacity], src[4 * capacity],
                         src[5 * capacity], (float)tx, (float)ty, power_guard,
                         &stage[0][p], kMaxPix);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          stage[kRgb + c][p] = src[(6 + c) * capacity];
      } else {
#pragma unroll
        for (int f = 0; f < kFields; ++f) stage[f][p] = src[f * capacity];
      }
    }
    __syncthreads();
    if (done) continue;
    const int m = min(pix, count - b0);
    for (int k = 0; k < m; ++k) {
      float raw;
      if constexpr (kMxu) {
        const float pw = mxu_power(&stage[0][k], kMaxPix, u);
        if (!(pw <= stage[kMxuCoefs - 1][k])) continue;
        raw = expf(pw);
      } else {
        const float dx = __fsub_rn(stage[0][k], fx);
        const float dy = __fsub_rn(stage[1][k], fy);
        // power = -0.5 (ca dx dx + cc dy dy) - cb dx dy
        const float qa = __fmul_rn(__fmul_rn(stage[2][k], dx), dx);
        const float qc = __fmul_rn(__fmul_rn(stage[4][k], dy), dy);
        const float power =
            __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                      __fmul_rn(__fmul_rn(stage[3][k], dx), dy));
        if (!(power <= 0.0f)) continue;
        raw = __fmul_rn(stage[5][k], expf(power));
      }
      const float alpha = raw > alpha_max ? alpha_max : raw;
      if (!(alpha >= alpha_min)) continue;
      const float s_new = __fadd_rn(s, log1pf(-alpha));
      const float t_after = expf(s_new);
      if (!(t_after >= t_eps)) {  // would cross eps: stop, do not apply
        done = true;
        break;
      }
      const float w =
          __fmul_rn(__fdiv_rn(t_after, __fsub_rn(1.0f, alpha)), alpha);
      cr = __fadd_rn(cr, __fmul_rn(w, stage[kRgb][k]));
      cg = __fadd_rn(cg, __fmul_rn(w, stage[kRgb + 1][k]));
      cb = __fadd_rn(cb, __fmul_rn(w, stage[kRgb + 2][k]));
      s = s_new;
      t = t_after;
    }
  }
  const int64_t o = (int64_t)tile * pix + p;
  out_color[3 * o + 0] = cr;
  out_color[3 * o + 1] = cg;
  out_color[3 * o + 2] = cb;
  out_t[o] = t;
}

}  // namespace

// mxu: 0 = blend_quad "vpu", 1 = "mxu"
extern "C" int rasterize_forward_launch(
    const float* payload, int64_t capacity, const int32_t* tile_starts,
    const int32_t* tile_counts, int num_tiles, int grid_x, int width,
    int height, int tile_w, int tile_h, int mxu, float alpha_max,
    float alpha_min, float t_eps, float power_guard, float* out_color,
    float* out_t, cudaStream_t stream) {
  auto kernel = mxu ? rasterize_forward_kernel<true>
                    : rasterize_forward_kernel<false>;
  kernel<<<num_tiles, tile_w * tile_h, 0, stream>>>(
      payload, capacity, tile_starts, tile_counts, grid_x, width, height,
      tile_w, tile_h, alpha_max, alpha_min, t_eps, power_guard, out_color,
      out_t);
  return (int)cudaGetLastError();
}
