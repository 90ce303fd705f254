// Tile-rect expansion: gaussians -> (tile, depth, gid) entries.
//
// Replaces the TPU kernel luisacomputegaussiansplatting_tpu/ops/expand_pallas.py
// `_expand_kernel` (launched by `expand_entries_pallas`), which rebuilt the
// variable-fanout key scatter of the reference (lcgs/src/gs_tile_splatter/
// shader.cpp:26-69, shad_copy_with_keys) as a streamed one-hot matmul with an
// f32 hi/lo offset split. None of that is carried over: slots and tiles are
// integers here.
//
// What bounds it on the card: memory traffic (each gaussian's 28-52-byte
// record read once, 12 bytes written a slot). A slot's owner is the
// gaussian whose range [ends[g-1], ends[g]) holds it; finding it with a
// binary search over the 2M-entry int64 `ends` (16 MB, in L2), as this
// kernel's first version did, costs ~21 dependent L2 round trips a slot.
//
// Design: no search in device memory. Warp w owns gaussians [32w, 32w + 32)
// and so the contiguous run of slots [ends[32w - 1], ends[32w + 31]). Lane l
// loads gaussian 32w + l once (its range, rect, depth and, with the cull,
// its conic and the cull's per-gaussian terms), then the warp walks its run
// 32 slots at a time: each lane finds its slot's owner among the 32 lanes
// with a 5-step search over the lanes' range starts (shuffles), fetches the
// owner's record from its lane (shuffles) and writes the slot, so
// neighbouring lanes write neighbouring slots (coalesced stores) however the
// fan-out varies, and a gaussian of thousands of tiles is shared by the
// warp. Within a gaussian the order is y-outer, x-inner, as in the reference
// scatter. The runs are split by gaussians, not by slots, so a warp walks its
// gaussians' rects alone, however large: a run holds at most 32 num_tiles
// slots (num_tiles steps of 32; the strict frame's 8,160 tiles), against a
// mean of ~122 slots at the strict frame and ~67 at the production one. Slots in [min(total, max_pairs), max_pairs) are invalid, written
// by a grid-stride loop of every thread after its warp's run. The total
// itself is saturated here from the wrapper's cumsum and float32 re-sum,
// as ops/expand.py::saturated_ends does from the same two tensors.
//
// The output must equal the plain PyTorch version (ops/binning.py
// expand_entries) bit for bit, so the ellipse-tile test is written with
// explicit round-to-nearest intrinsics (no FMA contraction) and the same logf
// and IEEE division as the plain version's torch ops; its per-gaussian terms
// (the two edge slopes and log(op / alpha_min)) are computed once a gaussian,
// with the same ops, so they carry the same bits as a per-slot evaluation.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// q(d) = 0.5 (ca dx^2 + cc dy^2) + cb dx dy: the op order of ops/expand.py
// ellipse_tile_reaches
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

// One gaussian's record as the slots read it.
struct Owner {
  int32_t lo;                  // first slot
  int32_t min_x, min_y, rect_w;
  float depth;
  float mx, my, ca, cb, cc;    // cull only
  float kx, ky, log_reach;     // cull only: cb/cc, cb/ca, log(op/alpha_min)
};

// Lane src's record (the cull's fields only with kCull).
template <bool kCull>
__device__ __forceinline__ Owner shfl_owner(const Owner& o, int src) {
  Owner r = {};
  r.lo = __shfl_sync(kFull, o.lo, src);
  r.min_x = __shfl_sync(kFull, o.min_x, src);
  r.min_y = __shfl_sync(kFull, o.min_y, src);
  r.rect_w = __shfl_sync(kFull, o.rect_w, src);
  r.depth = __shfl_sync(kFull, o.depth, src);
  if (!kCull) return r;
  r.mx = __shfl_sync(kFull, o.mx, src);
  r.my = __shfl_sync(kFull, o.my, src);
  r.ca = __shfl_sync(kFull, o.ca, src);
  r.cb = __shfl_sync(kFull, o.cb, src);
  r.cc = __shfl_sync(kFull, o.cc, src);
  r.kx = __shfl_sync(kFull, o.kx, src);
  r.ky = __shfl_sync(kFull, o.ky, src);
  r.log_reach = __shfl_sync(kFull, o.log_reach, src);
  return r;
}

// Can any pixel centre of the box [x0,x1]x[y0,y1] receive alpha >= alpha_min?
// The minimum over the box of q is 0 if the mean is inside, else the best of
// the four edge-constrained minimisers.
__device__ __forceinline__ bool ellipse_tile_reaches(const Owner& o, float x0,
                                                     float x1, float y0,
                                                     float y1) {
  const float mx = o.mx, my = o.my, ca = o.ca, cb = o.cb, cc = o.cc;
  bool inside = (mx >= x0) && (mx <= x1) && (my >= y0) && (my <= y1);
  float q_min = 0.0f;
  if (!inside) {
    float e[4];
    // edge_x(xe): dx = xe - mx, ys = clamp(my - (cb/cc) dx, y0, y1)
    float xs_[2] = {x0, x1};
    for (int i = 0; i < 2; ++i) {
      float dx = __fsub_rn(xs_[i], mx);
      float ys = clampf(__fsub_rn(my, __fmul_rn(o.kx, dx)), y0, y1);
      e[i] = quad(ca, cb, cc, dx, __fsub_rn(ys, my));
    }
    // edge_y(ye): dy = ye - my, xs = clamp(mx - (cb/ca) dy, x0, x1)
    float ys_[2] = {y0, y1};
    for (int i = 0; i < 2; ++i) {
      float dy = __fsub_rn(ys_[i], my);
      float xs = clampf(__fsub_rn(mx, __fmul_rn(o.ky, dy)), x0, x1);
      e[2 + i] = quad(ca, cb, cc, __fsub_rn(xs, mx), dy);
    }
    q_min = fminf(fminf(e[0], e[1]), fminf(e[2], e[3]));
  }
  return q_min <= o.log_reach;
}

// The saturated AABB slot total (ops/expand.py::saturated_ends): the last
// inclusive end, pinned to 2^31 - 1 where the float32 re-sum reaches it.
__device__ __forceinline__ int64_t saturated_total(
    const int64_t* __restrict__ ends, int64_t num_gaussians,
    const float* __restrict__ total_f) {
  int64_t t = num_gaussians > 0 ? ends[num_gaussians - 1] : 0;
  if (*total_f >= 2147483647.0f) t = INT32_MAX;
  return min(t, (int64_t)INT32_MAX);
}

// Gaussian g's record and its slot range [o.lo, *hi), cut at lim (empty for
// g >= num_gaussians, at the end of the last range); the cull's per-gaussian
// terms where opacity is given.
__device__ __forceinline__ Owner load_owner(
    int64_t g, int64_t num_gaussians, int64_t lim,
    const int64_t* __restrict__ ends, const int32_t* __restrict__ rect_min,
    const int32_t* __restrict__ rect_max, const float* __restrict__ depth,
    const float* __restrict__ means2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, float alpha_min, int32_t* hi) {
  Owner o = {};
  o.rect_w = 1;
  *hi = 0;
  if (num_gaussians > 0) {
    const int64_t last = ends[num_gaussians - 1];
    const int64_t e_lo = g == 0 ? 0 : (g <= num_gaussians ? ends[g - 1] : last);
    const int64_t e_hi = g < num_gaussians ? ends[g] : last;
    o.lo = (int32_t)min(e_lo, lim);
    *hi = (int32_t)min(e_hi, lim);
  }
  if (g < num_gaussians && *hi > o.lo) {
    o.min_x = rect_min[2 * g];
    o.min_y = rect_min[2 * g + 1];
    o.rect_w = max(rect_max[2 * g] - o.min_x, 1);
    o.depth = depth[g];
    if (opacity != nullptr) {
      o.mx = means2d[2 * g];
      o.my = means2d[2 * g + 1];
      o.ca = conic[3 * g];
      o.cb = conic[3 * g + 1];
      o.cc = conic[3 * g + 2];
      o.kx = __fdiv_rn(o.cb, fmaxf(o.cc, 1e-12f));
      o.ky = __fdiv_rn(o.cb, fmaxf(o.ca, 1e-12f));
      o.log_reach = logf(__fdiv_rn(fmaxf(opacity[g], 1e-12f), alpha_min));
    }
  }
  return o;
}

// Slot `slot` of owner o's rect (local index slot - o.lo): (tile, depth,
// gid), invalid where the cull drops the tile.
template <bool kCull>
__device__ __forceinline__ void write_slot(
    const Owner& o, int32_t gid, int32_t slot, int grid_x,
    int num_tiles, int tile_w, int tile_h, int32_t* __restrict__ out_tile,
    float* __restrict__ out_depth, int32_t* __restrict__ out_gid) {
  const int32_t local = slot - o.lo;
  const int32_t tx = o.min_x + local % o.rect_w;
  const int32_t ty = o.min_y + local / o.rect_w;
  bool keep = true;
  if (kCull) {
    float x0 = (float)(tx * tile_w);
    float x1 = __fadd_rn(x0, (float)(tile_w - 1));
    float y0 = (float)(ty * tile_h);
    float y1 = __fadd_rn(y0, (float)(tile_h - 1));
    keep = ellipse_tile_reaches(o, x0, x1, y0, y1);
  }
  out_tile[slot] = keep ? tx + ty * grid_x : num_tiles;
  out_depth[slot] = keep ? o.depth : CUDART_INF_F;
  out_gid[slot] = keep ? gid : -1;
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads) expand_kernel(
    const int64_t* __restrict__ ends,    // (P,) inclusive cumsum of tiles_touched
    const float* __restrict__ total_f,   // () float32 sum of tiles_touched
    const int32_t* __restrict__ rect_min,  // (P, 2)
    const int32_t* __restrict__ rect_max,  // (P, 2)
    const float* __restrict__ depth,       // (P,)
    const float* __restrict__ means2d,     // (P, 2), cull only
    const float* __restrict__ conic,       // (P, 3), cull only
    const float* __restrict__ opacity,     // (P,), cull only
    int64_t num_gaussians, int64_t max_pairs, int grid_x, int num_tiles,
    int tile_w, int tile_h, float alpha_min, int32_t* __restrict__ out_tile,
    float* __restrict__ out_depth, int32_t* __restrict__ out_gid,
    int64_t* __restrict__ out_total) {  // () saturated AABB slot total
  const int64_t total = saturated_total(ends, num_gaussians, total_f);
  // every valid slot is below lim <= max_pairs < 2^31
  const int64_t lim = min(total, max_pairs);
  const int lane = threadIdx.x & 31;
  const int64_t thread = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (thread == 0) *out_total = total;

  // this lane's gaussian: lane l of warp w holds gaussian 32 w + l
  int32_t hi;
  const int64_t g = thread;
  const Owner o = load_owner(g, num_gaussians, lim, ends, rect_min, rect_max,
                             depth, means2d, conic, opacity, alpha_min, &hi);

  // the warp's run of slots, 32 at a time; the owner of a slot is the last
  // lane whose range starts at or before it (lanes with empty ranges start
  // where the next range does, so they are never the last)
  const int32_t run_lo = __shfl_sync(kFull, o.lo, 0);
  const int32_t run_hi = __shfl_sync(kFull, hi, 31);
  const int32_t gid0 = (int32_t)(g - lane);
  for (int32_t base = run_lo; base < run_hi; base += 32) {
    const int32_t slot = base + lane;
    int src = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const int32_t start = __shfl_sync(kFull, o.lo, src + step);
      if (start <= slot) src += step;
    }
    const Owner owner = shfl_owner<kCull>(o, src);
    if (slot < run_hi)
      write_slot<kCull>(owner, gid0 + src, slot, grid_x, num_tiles, tile_w,
                        tile_h, out_tile, out_depth, out_gid);
  }

  // the invalid tail
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t slot = lim + thread; slot < max_pairs; slot += stride) {
    out_tile[slot] = num_tiles;
    out_depth[slot] = CUDART_INF_F;
    out_gid[slot] = -1;
  }
}

// A thread a gaussian, and at least ~4 blocks an SM for the invalid tail
// (at least one block: it writes the total).
__host__ __forceinline__ int64_t expand_blocks(int64_t num_gaussians,
                                               int64_t max_pairs) {
  const int64_t tail = min((max_pairs + kThreads - 1) / kThreads, (int64_t)528);
  return max(max((num_gaussians + kThreads - 1) / kThreads, tail), (int64_t)1);
}

}  // namespace

extern "C" int expand_entries_launch(
    const int64_t* ends, const float* total_f, const int32_t* rect_min,
    const int32_t* rect_max, const float* depth, const float* means2d,
    const float* conic, const float* opacity, int64_t num_gaussians,
    int64_t max_pairs, int grid_x, int num_tiles, int tile_w, int tile_h,
    float alpha_min, int32_t* out_tile, float* out_depth, int32_t* out_gid,
    int64_t* out_total, cudaStream_t stream) {
  // slots are int32: a warp's last step of 32 must not pass INT32_MAX
  if (max_pairs < 0 || max_pairs > INT32_MAX - 32 || num_gaussians < 0 ||
      num_gaussians > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  auto kernel = opacity != nullptr ? expand_kernel<true> : expand_kernel<false>;
  kernel<<<(unsigned)expand_blocks(num_gaussians, max_pairs), kThreads, 0,
           stream>>>(
      ends, total_f, rect_min, rect_max, depth, means2d, conic, opacity,
      num_gaussians, max_pairs, grid_x, num_tiles, tile_w, tile_h, alpha_min,
      out_tile, out_depth, out_gid, out_total);
  return (int)cudaGetLastError();
}
