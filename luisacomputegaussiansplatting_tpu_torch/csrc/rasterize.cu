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
// one block per tile, entries staged through shared memory and blended
// sequentially by each pixel.
//
// Each pixel's chain is fixed, op for op: the power (vpu: the conic
// quadratic; mxu: blend_mxu.cuh's polynomial), the clamp at alpha_max, the
// alpha_min test, s += log1p(-alpha), T = exp(s), the sticky stop where T
// would fall below eps (the entry is not applied), the weight and the colour
// sums, every op with an explicit round-to-nearest intrinsic in the plain
// PyTorch version's order (ops/rasterize_ref.py). The backward blend
// (rasterize_backward.cu) replays exactly these decisions, and one
// contracted FMA moves a power by ~1e-4 and flips a test, so the design
// changes only which (entry, pixel) pairs are evaluated and how pixels map
// onto threads: the colour and T are the same bits for every launch shape.
//
// What bounds it on the card: the instructions a warp issues, not FP32
// throughput. The production frame evaluates ~534M (entry, pixel) pairs and
// applies ~95M of them: ~82% of the evaluated pairs fail the power or alpha
// test, and a warp pays for a pair as long as one of its lanes' pixels is
// still live. Device memory traffic is small: each entry's 36-byte record is
// read once per tile.
//
// Design:
//  * Pixels come in groups of 32, one pixel a lane: an 8x4 box of the tile
//    where the tile is whole boxes (the wrapper's table,
//    ops/rasterize.py::forward_pixel_map). Each thread owns P = 2 or 1
//    pixels, one in each of its warp's P groups (a template parameter; the
//    wrapper's forward_launch_shape picks it from the tile: P = 2 at tile
//    16 and 32, at tile 32 a 512-thread block, two blocks an SM), and the P
//    pixels share each staged entry's shared-memory loads. P = 4 was slower
//    at both tiles (80 registers, fewer warps an SM; PERF.md).
//  * A warp evaluates an entry for a group only where it can matter:
//    - the group still has a live pixel (a warp-wide vote at each batch);
//    - the entry can reach the group's box. The thread that stages an entry
//      computes the most q a kept pair can have, thr: ln(op / alpha_min)
//      (mxu: ln(op) - ln(alpha_min), with the mode's clamp of op) plus a
//      margin of 1e-4 of the magnitude of the power's terms (FP32 rounds
//      the power by ~1e-6 of it) and 1e-3; then two bounds of the region
//      q <= thr: the disc q(d) >= 0.5 lmin |d|^2 (lmin the smaller
//      eigenvalue of the conic, rounded down) and the ellipse's
//      axis-aligned extent. Each lane tests two of the batch's entries
//      against its warp's group boxes; a pair outside either bound is one
//      the exact chain would not apply, so skipping it changes no bit.
//    Both tests are uniform across the warp: a skipped evaluation costs no
//    issue slot. Without the reach test K2 took 1.5-1.8x as long (PERF.md).
//  * Entries are staged in 64-entry batches (shared memory sized by the
//    batch: 3.8 KB a block in vpu, 4.6 KB in mxu, the group boxes
//    included) with coalesced field-major reads; for mxu the thread that
//    stages an entry computes its coefficients and guard limit
//    (blend_mxu.cuh).
//  * The wrapper passes the tiles in descending order of their entry
//    counts (block b blends tile tile_order[b]), so the longest tiles do
//    not start in the last wave.
//  * Early exit: a warp skips a batch when all of its groups have stopped;
//    the tile leaves its entry loop through a block-wide vote
//    (__syncthreads_count); every thread reaches every barrier.
//  * Pixels past the image edge start stopped with T = 0 and are written
//    like the others; pad lanes (a tile whose pixel count is not a multiple
//    of 32) own no pixel.
//  * One kernel serves both pack modes: it reads [start, start + count);
//    "chunk" padding entries carry opacity 0 and never pass alpha_min.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blend_mxu.cuh"

namespace {

constexpr int kFields = 9;
constexpr int kMaxPix = 1024;
constexpr int kBatch = 64;  // entries staged per round: two a lane
constexpr unsigned kFull = 0xffffffffu;

// The reach bound of one entry: a pixel can pass the keep test only where
// q(d) <= thr, and q(d) >= cm |d|^2 everywhere, so only within |d|^2 <=
// thr / cm of the mean and, as {q <= thr} is an ellipse, within |dx| <= rx,
// |dy| <= ry. thr = +inf and rx = ry = +inf (never cull) where the conic is
// not safely positive definite or a term is not finite.
__device__ __forceinline__ void reach_bound(float mx, float my, float ca,
                                            float cb, float cc, float op,
                                            float tx0, float ty0, int tile_wh,
                                            float ln_alpha_min, bool mxu,
                                            float* cm, float* thr, float* rx,
                                            float* ry) {
  // the smaller eigenvalue as det / lmax (no cancellation), with det and
  // the quotient rounded down by far more than their FP32 error
  const float hd = 0.5f * (ca - cc);
  const float lmax = 0.5f * (ca + cc) + sqrtf(hd * hd + cb * cb);
  const float det_lo = ca * cc - cb * cb - 1e-5f * (fabsf(ca * cc) + cb * cb);
  const float lmin = det_lo / (lmax * 1.0001f) * 0.9999f;
  // the least q a kept pair can have: vpu op exp(-q) >= alpha_min, mxu
  // exp(ln(max(op, 1e-30)) - q) >= alpha_min
  const float reach = logf(mxu ? fmaxf(op, 1e-30f) : op) - ln_alpha_min;
  const float d = fmaxf(fabsf(mx - tx0), fabsf(my - ty0)) + (float)tile_wh;
  const float terms =
      (fabsf(ca) + fabsf(cc) + 2.0f * fabsf(cb)) * d * d + fabsf(reach) + 1.0f;
  const float t = reach + 1e-4f * terms + 1e-3f;
  const bool ok = lmin > 0.0f && lmin < CUDART_INF_F && t < CUDART_INF_F &&
                  fabsf(mx) < 1e30f && fabsf(my) < 1e30f;
  *cm = ok ? 0.5f * lmin : 0.0f;
  *thr = ok ? t : CUDART_INF_F;
  // the extent of {0.5 d^T C d <= t}: |dx| <= sqrt(2 t (C^-1)_xx), (C^-1)_xx
  // = cc / det (thr < 0: the disc bound alone culls every pixel)
  const bool ext = ok && t >= 0.0f;
  *rx = ext ? sqrtf(2.0f * t * cc / det_lo) * 1.0001f + 1e-3f : CUDART_INF_F;
  *ry = ext ? sqrtf(2.0f * t * ca / det_lo) * 1.0001f + 1e-3f : CUDART_INF_F;
}

// Registers: at most 64 a thread (P = 2: two 512-thread blocks an SM).
template <bool kMxu, int P>
__global__ void __launch_bounds__(kMaxPix / P, P == 2 ? 2 : 1)
rasterize_forward_kernel(const float* __restrict__ payload,  // (9, capacity)
                         int64_t capacity,
                         const int32_t* __restrict__ tile_starts,
                         const int32_t* __restrict__ tile_counts,
                         const int32_t* __restrict__ pixel_map,  // (threads, P)
                         const int64_t* __restrict__ tile_order,
                         int grid_x, int tile_offset, int width, int height,
                         int tile_w,
                         int tile_h, float alpha_max, float alpha_min,
                         float t_eps, float power_guard,
                         float* __restrict__ out_color,  // (tiles, pix, 3)
                         float* __restrict__ out_t) {    // (tiles, pix, 1)
  // staged rows. vpu: the 9 payload fields; mxu: the coefficients, r, g, b
  // and the mean. Then the reach bound (cm, thr, rx, ry).
  constexpr int kRgb = kMxu ? kMxuCoefs : 6;
  constexpr int kMean = kMxu ? kMxuCoefs + 3 : 0;
  constexpr int kCm = kMxu ? kMxuCoefs + 5 : kFields;
  constexpr int kRows = kCm + 4;  // cm, thr, rx, ry
  __shared__ float stage[kRows][kBatch];
  __shared__ float4 group_box[kMaxPix / 32];  // x0, x1, y0, y1 of a group
  const int n_threads = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = (int)tile_order[blockIdx.x];
  // the origin of the tile's place in the whole frame: a band of a sharded
  // frame (parallel/render_sharded.py) starts at global tile tile_offset
  const int gtile = tile_offset + tile;
  const int tx = (gtile % grid_x) * tile_w, ty = (gtile / grid_x) * tile_h;
  const int64_t start = tile_starts[tile];
  const int count = tile_counts[tile];
  const float ln_alpha_min = logf(alpha_min);

  int p[P];               // tile-local pixel index, -1 = none
  float fx[P], fy[P];     // vpu
  MxuBasis u[P];          // mxu
  float s[P], tr[P];      // log-transmittance, T after the last applied
  float cr[P], cg[P], cb[P];
  unsigned live = 0;      // bit i: pixel i is inside the image, not stopped
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = pixel_map[t * P + i];
    const int q = p[i] < 0 ? 0 : p[i];
    const int ix = tx + q % tile_w;
    const int iy = ty + q / tile_w;
    const bool inside = p[i] >= 0 && ix < width && iy < height;
    if (inside) live |= 1u << i;
    fx[i] = (float)ix;
    fy[i] = (float)iy;
    u[i] = mxu_basis(q, tile_w);  // unused by vpu
    s[i] = 0.0f;
    tr[i] = inside ? 1.0f : 0.0f;
    cr[i] = cg[i] = cb[i] = 0.0f;
    // the box of the group's pixels inside the image
    const int x0 = __reduce_min_sync(kFull, inside ? ix : INT32_MAX);
    const int x1 = __reduce_max_sync(kFull, inside ? ix : INT32_MIN);
    const int y0 = __reduce_min_sync(kFull, inside ? iy : INT32_MAX);
    const int y1 = __reduce_max_sync(kFull, inside ? iy : INT32_MIN);
    if (lane == 0)
      group_box[warp * P + i] =
          make_float4((float)x0, (float)x1, (float)y0, (float)y1);
  }
  __syncwarp();

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // barrier + early exit: also orders the previous batch's reads before
    // this batch's writes to shared memory
    if (__syncthreads_count(live != 0) == 0) break;
    const int m = min(kBatch, count - b0);
    for (int e = t; e < m; e += n_threads) {
      const float* src = payload + start + b0 + e;
      const float mx = src[0], my = src[capacity];
      const float ca = src[2 * capacity], cbv = src[3 * capacity];
      const float cc = src[4 * capacity], op = src[5 * capacity];
      if constexpr (kMxu) {
        mxu_coefficients(mx, my, ca, cbv, cc, op, (float)tx, (float)ty,
                         power_guard, &stage[0][e], kBatch);
        stage[kMean][e] = mx;
        stage[kMean + 1][e] = my;
      } else {
        stage[0][e] = mx;
        stage[1][e] = my;
        stage[2][e] = ca;
        stage[3][e] = cbv;
        stage[4][e] = cc;
        stage[5][e] = op;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) stage[kRgb + c][e] = src[(6 + c) * capacity];
      reach_bound(mx, my, ca, cbv, cc, op, (float)tx, (float)ty,
                  max(tile_w, tile_h), ln_alpha_min, kMxu, &stage[kCm][e],
                  &stage[kCm + 1][e], &stage[kCm + 2][e], &stage[kCm + 3][e]);
    }
    __syncthreads();
    // the warp's live groups, then which of them each entry can reach:
    // lane l tests entries l and l + 32
    unsigned groups = 0;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (__any_sync(kFull, live & (1u << i))) groups |= 1u << i;
    if (groups == 0) continue;  // the warp has stopped
    unsigned reach[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = lane + 32 * h;
      if (e >= m) continue;
      const float mx = stage[kMean][e], my = stage[kMean + 1][e];
      const float cm = stage[kCm][e], thr = stage[kCm + 1][e];
      const float rx = stage[kCm + 2][e], ry = stage[kCm + 3][e];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float4 box = group_box[warp * P + i];
        // the distance from the mean to the box along x and y
        const float dx = fmaxf(fmaxf(box.x - mx, mx - box.y), 0.0f);
        const float dy = fmaxf(fmaxf(box.z - my, my - box.w), 0.0f);
        const bool out = cm * (dx * dx + dy * dy) > thr || dx > rx || dy > ry;
        if (!out) reach[h] |= 1u << i;
      }
    }
    for (int k = 0; k < m; ++k) {
      // uniform across the warp: the groups that evaluate entry k
      const unsigned todo =
          __shfl_sync(kFull, k < 32 ? reach[0] : reach[1], k & 31) & groups;
      if (todo == 0) continue;
      // the powers and their keep tests
      float pw[P];
      unsigned hit = 0;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (!(todo & (1u << i))) continue;
        bool keep;
        if constexpr (kMxu) {
          pw[i] = mxu_power(&stage[0][k], kBatch, u[i]);
          keep = pw[i] <= stage[kMxuCoefs - 1][k];
        } else {
          const float dx = __fsub_rn(stage[0][k], fx[i]);
          const float dy = __fsub_rn(stage[1][k], fy[i]);
          // power = -0.5 (ca dx dx + cc dy dy) - cb dx dy
          const float qa = __fmul_rn(__fmul_rn(stage[2][k], dx), dx);
          const float qc = __fmul_rn(__fmul_rn(stage[4][k], dy), dy);
          pw[i] = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)),
                            __fmul_rn(__fmul_rn(stage[3][k], dx), dy));
          keep = pw[i] <= 0.0f;
        }
        if (keep) hit |= 1u << i;
      }
      hit &= live;
      if (hit == 0) continue;
      // the alpha_min test, the log-sum step, the stop test and the colour
      // sums of each pixel that passes
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (!(hit & (1u << i))) continue;
        const float raw = kMxu ? expf(pw[i])
                               : __fmul_rn(stage[5][k], expf(pw[i]));
        const float alpha = raw > alpha_max ? alpha_max : raw;
        if (!(alpha >= alpha_min)) continue;
        const float s_new = __fadd_rn(s[i], log1pf(-alpha));
        const float t_after = expf(s_new);
        if (!(t_after >= t_eps)) {  // would cross eps: stop, do not apply
          live &= ~(1u << i);
          continue;
        }
        const float w =
            __fmul_rn(__fdiv_rn(t_after, __fsub_rn(1.0f, alpha)), alpha);
        cr[i] = __fadd_rn(cr[i], __fmul_rn(w, stage[kRgb][k]));
        cg[i] = __fadd_rn(cg[i], __fmul_rn(w, stage[kRgb + 1][k]));
        cb[i] = __fadd_rn(cb[i], __fmul_rn(w, stage[kRgb + 2][k]));
        s[i] = s_new;
        tr[i] = t_after;
      }
    }
  }
  const int pix = tile_w * tile_h;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (p[i] < 0) continue;
    const int64_t o = (int64_t)tile * pix + p[i];
    out_color[3 * o + 0] = cr[i];
    out_color[3 * o + 1] = cg[i];
    out_color[3 * o + 2] = cb[i];
    out_t[o] = tr[i];
  }
}

using ForwardKernel = void (*)(const float*, int64_t, const int32_t*,
                               const int32_t*, const int32_t*, const int64_t*,
                               int, int, int, int, int, int, float, float,
                               float, float, float*, float*);

template <bool kMxu>
ForwardKernel pick_kernel(int pix_per_thread) {
  switch (pix_per_thread) {
    case 1: return rasterize_forward_kernel<kMxu, 1>;
    case 2: return rasterize_forward_kernel<kMxu, 2>;
    default: return nullptr;
  }
}

}  // namespace

// mxu: 0 = blend_quad "vpu", 1 = "mxu"; pix_per_thread: 1 or 2;
// pixel_map: (threads, pix_per_thread) int32 tile-local pixel indices (-1 =
// none), every pixel of the tile exactly once; threads a multiple of 32,
// threads * pix_per_thread <= 1024; tile_order: (num_tiles,) int64, a
// permutation of the tiles, block b blends tile tile_order[b]; local tile i
// lies at global tile tile_offset + i of the grid_x-wide grid
extern "C" int rasterize_forward_launch(
    const float* payload, int64_t capacity, const int32_t* tile_starts,
    const int32_t* tile_counts, const int32_t* pixel_map,
    const int64_t* tile_order, int num_tiles,
    int threads, int pix_per_thread, int grid_x, int tile_offset, int width,
    int height,
    int tile_w, int tile_h, int mxu, float alpha_max, float alpha_min,
    float t_eps, float power_guard, float* out_color, float* out_t,
    cudaStream_t stream) {
  const ForwardKernel kernel = mxu ? pick_kernel<true>(pix_per_thread)
                                   : pick_kernel<false>(pix_per_thread);
  if (kernel == nullptr || tile_order == nullptr || threads <= 0 ||
      tile_offset < 0 ||
      threads % 32 != 0 ||
      threads * pix_per_thread > kMaxPix ||
      tile_w * tile_h > threads * pix_per_thread)
    return (int)cudaErrorInvalidValue;
  kernel<<<num_tiles, threads, 0, stream>>>(
      payload, capacity, tile_starts, tile_counts, pixel_map, tile_order,
      grid_x, tile_offset, width, height, tile_w, tile_h, alpha_max,
      alpha_min, t_eps, power_guard, out_color, out_t);
  return (int)cudaGetLastError();
}
