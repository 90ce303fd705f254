// Forward tile rasterizer: front-to-back alpha blending of each tile's
// (tile, depth)-sorted splat entries.
//
// Replaces the TPU kernel luisacomputegaussiansplatting_tpu/ops/
// rasterize_pallas.py `_forward_kernel` (launched by `rasterize_forward`,
// wrapped by the custom VJP `rasterize_tiles`), blend_quad="vpu". The TPU
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 9;
constexpr int kMaxPix = 1024;

__global__ void __launch_bounds__(kMaxPix)
rasterize_forward_kernel(const float* __restrict__ payload,  // (9, capacity)
                         int64_t capacity,
                         const int32_t* __restrict__ tile_starts,
                         const int32_t* __restrict__ tile_counts, int grid_x,
                         int width, int height, int tile_w, int tile_h,
                         float alpha_max, float alpha_min, float t_eps,
                         float* __restrict__ out_color,  // (tiles, pix, 3)
                         float* __restrict__ out_t) {    // (tiles, pix, 1)
  __shared__ float stage[kFields][kMaxPix];
  const int pix = tile_w * tile_h;  // == blockDim.x
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int ix = (tile % grid_x) * tile_w + p % tile_w;
  const int iy = (tile / grid_x) * tile_h + p / tile_w;
  const bool inside = ix < width && iy < height;
  const float fx = (float)ix, fy = (float)iy;
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
#pragma unroll
      for (int f = 0; f < kFields; ++f) stage[f][p] = src[f * capacity];
    }
    __syncthreads();
    if (done) continue;
    const int m = min(pix, count - b0);
    for (int k = 0; k < m; ++k) {
      const float dx = __fsub_rn(stage[0][k], fx);
      const float dy = __fsub_rn(stage[1][k], fy);
      // power = -0.5 (ca dx dx + cc dy dy) - cb dx dy
      const float qa = __fmul_rn(__fmul_rn(stage[2][k], dx), dx);
      const float qc = __fmul_rn(__fmul_rn(stage[4][k], dy), dy);
      const float power =
          __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                    __fmul_rn(__fmul_rn(stage[3][k], dx), dy));
      if (!(power <= 0.0f)) continue;
      const float raw = __fmul_rn(stage[5][k], expf(power));
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
      cr = __fadd_rn(cr, __fmul_rn(w, stage[6][k]));
      cg = __fadd_rn(cg, __fmul_rn(w, stage[7][k]));
      cb = __fadd_rn(cb, __fmul_rn(w, stage[8][k]));
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

extern "C" int rasterize_forward_launch(
    const float* payload, int64_t capacity, const int32_t* tile_starts,
    const int32_t* tile_counts, int num_tiles, int grid_x, int width,
    int height, int tile_w, int tile_h, float alpha_max, float alpha_min,
    float t_eps, float* out_color, float* out_t, cudaStream_t stream) {
  rasterize_forward_kernel<<<num_tiles, tile_w * tile_h, 0, stream>>>(
      payload, capacity, tile_starts, tile_counts, grid_x, width, height,
      tile_w, tile_h, alpha_max, alpha_min, t_eps, out_color, out_t);
  return (int)cudaGetLastError();
}
