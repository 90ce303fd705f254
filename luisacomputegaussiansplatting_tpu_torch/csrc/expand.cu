// Tile-rect expansion: gaussians -> (tile, depth, gid) entries.
//
// Replaces the TPU kernel luisacomputegaussiansplatting_tpu/ops/expand_pallas.py
// `_expand_kernel` (launched by `expand_entries_pallas`), which rebuilt the
// variable-fanout key scatter of the reference (lcgs/src/gs_tile_splatter/
// shader.cpp:26-69, shad_copy_with_keys) as a streamed one-hot matmul with an
// f32 hi/lo offset split. None of that is carried over: slots and tiles are
// integers here.
//
// What bounds it on the card: memory traffic. Each output slot writes 12 bytes
// (tile id, depth, gid) and reads its gaussian's record (~40 bytes with the
// cull, from L2 for the neighbours that share a gaussian); the binary search
// adds ~log2(P) reads of the inclusive cumsum, which stay in L2 for the top
// levels. Arithmetic is a few integer ops, and ~40 flops with the cull.
//
// Design: one thread per output slot. The slot's owner is the first gaussian
// whose inclusive end exceeds the slot (binary search in the int64 cumsum of
// tiles_touched), so every thread does the same amount of work whatever the
// fan-out of its gaussian, and neighbouring threads write neighbouring slots
// (coalesced stores). Within a gaussian the order is y-outer, x-inner, as in
// the reference scatter. The output must equal the plain PyTorch version
// (ops/binning.py expand_entries) bit for bit, so the ellipse-tile test is
// written with explicit round-to-nearest intrinsics (no FMA contraction) and
// the same logf and IEEE division as the plain version's torch ops.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// min over the tile's pixel-centre box [x0,x1]x[y0,y1] of the conic quadratic
// q(d) = 0.5 (ca dx^2 + cc dy^2) + cb dx dy, compared against
// log(op / alpha_min): the op order of ops/expand.py ellipse_tile_reaches.
__device__ __forceinline__ float quad(float ca, float cb, float cc, float dx,
                                      float dy) {
  float t1 = __fmul_rn(__fmul_rn(ca, dx), dx);
  float t2 = __fmul_rn(__fmul_rn(cc, dy), dy);
  float h = __fmul_rn(0.5f, __fadd_rn(t1, t2));
  return __fadd_rn(h, __fmul_rn(__fmul_rn(cb, dx), dy));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ bool ellipse_tile_reaches(float mx, float my, float ca, float cb,
                                     float cc, float op, float x0, float x1,
                                     float y0, float y1, float alpha_min) {
  bool inside = (mx >= x0) && (mx <= x1) && (my >= y0) && (my <= y1);
  float q_min = 0.0f;
  if (!inside) {
    float kx = __fdiv_rn(cb, fmaxf(cc, 1e-12f));
    float ky = __fdiv_rn(cb, fmaxf(ca, 1e-12f));
    float e[4];
    // edge_x(xe): dx = xe - mx, ys = clamp(my - (cb/cc) dx, y0, y1)
    float xs_[2] = {x0, x1};
    for (int i = 0; i < 2; ++i) {
      float dx = __fsub_rn(xs_[i], mx);
      float ys = clampf(__fsub_rn(my, __fmul_rn(kx, dx)), y0, y1);
      e[i] = quad(ca, cb, cc, dx, __fsub_rn(ys, my));
    }
    // edge_y(ye): dy = ye - my, xs = clamp(mx - (cb/ca) dy, x0, x1)
    float ys_[2] = {y0, y1};
    for (int i = 0; i < 2; ++i) {
      float dy = __fsub_rn(ys_[i], my);
      float xs = clampf(__fsub_rn(mx, __fmul_rn(ky, dy)), x0, x1);
      e[2 + i] = quad(ca, cb, cc, __fsub_rn(xs, mx), dy);
    }
    q_min = fminf(fminf(e[0], e[1]), fminf(e[2], e[3]));
  }
  return q_min <= logf(__fdiv_rn(fmaxf(op, 1e-12f), alpha_min));
}

__global__ void expand_kernel(
    const int64_t* __restrict__ ends,    // (P,) inclusive cumsum of tiles_touched
    const int64_t* __restrict__ total,   // () saturated AABB slot total
    const int32_t* __restrict__ rect_min,  // (P, 2)
    const int32_t* __restrict__ rect_max,  // (P, 2)
    const float* __restrict__ depth,       // (P,)
    const float* __restrict__ means2d,     // (P, 2), cull only
    const float* __restrict__ conic,       // (P, 3), cull only
    const float* __restrict__ opacity,     // (P,), null = no cull
    int64_t num_gaussians, int64_t max_pairs, int grid_x, int num_tiles,
    int tile_w, int tile_h, float alpha_min, int32_t* __restrict__ out_tile,
    float* __restrict__ out_depth, int32_t* __restrict__ out_gid) {
  int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= max_pairs) return;
  int64_t lim = min(*total, max_pairs);
  int32_t tile_id = num_tiles;
  float d = CUDART_INF_F;
  int32_t gid = -1;
  if (slot < lim) {
    // first g with ends[g] > slot
    int64_t lo = 0, hi = num_gaussians;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (ends[mid] > slot) hi = mid; else lo = mid + 1;
    }
    int64_t g = lo;
    int64_t start = g > 0 ? ends[g - 1] : 0;
    int32_t local = (int32_t)(slot - start);
    int32_t min_x = rect_min[2 * g], min_y = rect_min[2 * g + 1];
    int32_t rect_w = max(rect_max[2 * g] - min_x, 1);
    int32_t tx = min_x + local % rect_w;
    int32_t ty = min_y + local / rect_w;
    bool keep = true;
    if (opacity != nullptr) {
      float x0 = (float)(tx * tile_w);
      float x1 = __fadd_rn(x0, (float)(tile_w - 1));
      float y0 = (float)(ty * tile_h);
      float y1 = __fadd_rn(y0, (float)(tile_h - 1));
      keep = ellipse_tile_reaches(means2d[2 * g], means2d[2 * g + 1],
                                  conic[3 * g], conic[3 * g + 1],
                                  conic[3 * g + 2], opacity[g], x0, x1, y0, y1,
                                  alpha_min);
    }
    if (keep) {
      tile_id = tx + ty * grid_x;
      d = depth[g];
      gid = (int32_t)g;
    }
  }
  out_tile[slot] = tile_id;
  out_depth[slot] = d;
  out_gid[slot] = gid;
}

}  // namespace

extern "C" int expand_entries_launch(
    const int64_t* ends, const int64_t* total, const int32_t* rect_min,
    const int32_t* rect_max, const float* depth, const float* means2d,
    const float* conic, const float* opacity, int64_t num_gaussians,
    int64_t max_pairs, int grid_x, int num_tiles, int tile_w, int tile_h,
    float alpha_min, int32_t* out_tile, float* out_depth, int32_t* out_gid,
    cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (max_pairs + threads - 1) / threads;
  expand_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      ends, total, rect_min, rect_max, depth, means2d, conic, opacity,
      num_gaussians, max_pairs, grid_x, num_tiles, tile_w, tile_h, alpha_min,
      out_tile, out_depth, out_gid);
  return (int)cudaGetLastError();
}
