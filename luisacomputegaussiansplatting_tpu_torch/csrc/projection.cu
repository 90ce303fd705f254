// Projection (K6): gaussians -> pixel centres, depth, conic, radius and tile
// rects, and the backward of the centres and conics to the means, scales and
// quaternions, and on request to the camera.
//
// Replaces no TPU kernel. The JAX package's ops/projection.py is plain jnp
// code that XLA fuses into one pass. PyTorch's eager ops do not fuse: the
// plain version (ops/projection.py::project_gaussians_reference) costs about
// 330 launches forward and 410 backward, 18 ms of a training step at 6M
// gaussians on an H100. This pair does the same function in one launch each
// way.
//
// What bounds it on the card: device memory. Per gaussian, in f32, the
// forward reads the mean, scales and quaternion (40 B), the active mask (1 B)
// and the probe (8 B), and writes the centre, depth, conic, radius, both rect
// corners, tiles_touched and valid (49 B). The backward reads the mean, scales
// and quaternion and the centre and conic cotangents (60 B) and writes the
// three gradients (40 B); a camera gradient adds 56 B of per-gaussian terms,
// which the wrapper sums. Some 300 FP32 operations a gaussian forward and 400
// backward (a few IEEE divisions and square roots among them) take less time
// than those bytes at 3.35 TB/s.
//
// Design: one thread a gaussian, 256 a block. Every record is a few floats
// read or written by each thread directly: neighbouring threads touch
// neighbouring records, so a warp's loads and stores of a field fall on the
// same few cache lines, which L1 and L2 merge. The camera's constants (view
// rows, focal lengths, frustum limits, the tile reciprocals) are computed
// once a block by its first thread from the view matrix and tangents on the
// device, with torch's ops, and shared. The backward recomputes the forward
// from the inputs alone with the same code, so its near-cull and frustum-clamp
// masks are the forward's, then chains the derivatives analytically (the
// EWA Jacobian, the symmetric covariance products, the quaternion's rotation).
//
// The forward must equal the plain version bit for bit: radius, the rects and
// tiles_touched feed binning. So every product and sum is written with
// round-to-nearest intrinsics (no FMA contraction) in the plain version's
// order, `1.0 / t` is torch's reciprocal (an IEEE division) times 1.0,
// division by a 0-dim tensor an IEEE division and by a Python number a
// multiply by its float reciprocal (as torch does on CUDA), square roots are
// IEEE, the log is logf, clamps propagate NaN as torch's do, Python's sum()
// starts from 0 (which turns -0 into +0), and float -> int32 conversions
// truncate and saturate as torch's casts do. The backward's arithmetic may
// round differently from autograd's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// What the wrapper passes by value: image and tile grid, RenderConfig's
// constants as float32, and the ewa / focal modes (outside the anonymous
// namespace: the exported launchers take it).
struct Params {
  int64_t n;
  int width, height;
  int tile_w, tile_h, grid_x, grid_y;
  int max_x, max_y;  // the rect max's clamp: grid ("inria") or grid - 1
  int ewa_lcgs;      // V^T Sigma V instead of V Sigma V^T
  int use_focal;     // the focal-scaled Jacobian, else the unit-focal path
  float near, w_eps, frustum_clamp, lowpass, radius_sigma, det_eps;
  float alpha_min, scale_modifier;
  float nf_a, nf_b, nf_c;  // the unit-focal path's W*W/4, W*H/4, H*W/4
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// `1.0 / t` in torch: reciprocal(t), then a multiply by 1.0
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
// Python's sum() of three products: ((0 + a) + b) + c
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(add(0.0f, a), b), c);
}
// torch.clamp with tensor or scalar bounds: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// .to(torch.int32) of a float: truncation, saturating, NaN -> 0
__device__ __forceinline__ int to_int(float v) { return (int)v; }

// The camera's constants, each computed as the plain version's 0-dim
// tensor ops compute it.
struct Camera {
  float v[3][4];  // rows 0-2 of the world->view matrix
  float e[3][3];  // the EWA rotation: view3 ("inria") or its transpose
  float tan_x, tan_y;
  float lim_x, lim_y;      // frustum_clamp * tan
  float fx, fy;            // width / (2 tan), or 1 on the unit-focal path
  float k_a, k_b, k_c;     // 1 / (tan_x tan_x), 1 / (tan_x tan_y), ...
  float inv_tw, inv_th;    // x / tile: x * (1 / tile)
};

__device__ __forceinline__ Camera camera(const Params& p,
                                         const float* __restrict__ view,
                                         const float* __restrict__ tanx,
                                         const float* __restrict__ tany) {
  Camera c;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) c.v[i][j] = view[4 * i + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c.e[i][j] = p.ewa_lcgs ? view[4 * j + i] : view[4 * i + j];
  c.tan_x = tanx[0];
  c.tan_y = tany[0];
  c.lim_x = mul(c.tan_x, p.frustum_clamp);
  c.lim_y = mul(c.tan_y, p.frustum_clamp);
  if (p.use_focal) {
    c.fx = mul(rcp(mul(c.tan_x, 2.0f)), (float)p.width);
    c.fy = mul(rcp(mul(c.tan_y, 2.0f)), (float)p.height);
  } else {
    c.fx = 1.0f;
    c.fy = 1.0f;
  }
  c.k_a = rcp(mul(c.tan_x, c.tan_x));
  c.k_b = rcp(mul(c.tan_x, c.tan_y));
  c.k_c = rcp(mul(c.tan_y, c.tan_y));
  c.inv_tw = rcp((float)p.tile_w);
  c.inv_th = rcp((float)p.tile_h);
  return c;
}

// One gaussian's forward up to the conic: everything the backward reuses.
struct Fwd {
  float px, py, depth;
  bool in_front;
  float sz, inv_w, qx, qy, pix_x, pix_y;
  float r[3][3], s[3], m[3][3];
  float sv00, sv01, sv02, sv11, sv12, sv22;  // the view-space covariance
  float ux, uy, cx, cy, tx, ty;
  float inv_z, inv_z2, j00, j02, j11, j12;
  float cov[3][3];                            // the world-space covariance
  float a_raw, b_raw, c_raw;                  // J Sigma_view J^T
  float ap, b, cp, inv_det;                   // a + lowpass, b, c + lowpass
  float conic_a, conic_b, conic_c;
};

__device__ __forceinline__ Fwd forward_math(const Params& p, const Camera& c,
                                            const float* mean,
                                            const float* scale,
                                            const float* q) {
  Fwd f;
  const float mx = mean[0], my = mean[1], mz = mean[2];
  f.px = add(add(add(mul(mx, c.v[0][0]), mul(my, c.v[0][1])),
                 mul(mz, c.v[0][2])), c.v[0][3]);
  f.py = add(add(add(mul(mx, c.v[1][0]), mul(my, c.v[1][1])),
                 mul(mz, c.v[1][2])), c.v[1][3]);
  f.depth = add(add(add(mul(mx, c.v[2][0]), mul(my, c.v[2][1])),
                    mul(mz, c.v[2][2])), c.v[2][3]);
  f.in_front = f.depth >= p.near;
  f.sz = f.in_front ? f.depth : 1.0f;

  // NDC with the reference's +1e-6 on w, then ndc2pix
  f.inv_w = rcp(add(f.sz, p.w_eps));
  f.qx = dvd(f.px, c.tan_x);
  f.qy = dvd(f.py, c.tan_y);
  f.pix_x = mul(sub(mul(add(mul(f.qx, f.inv_w), 1.0f), (float)p.width), 1.0f),
                0.5f);
  f.pix_y = mul(sub(mul(add(mul(f.qy, f.inv_w), 1.0f), (float)p.height),
                    1.0f), 0.5f);

  // Sigma = R S S^T R^T (utils/gaussian.py::covariance_3d_elems)
  for (int j = 0; j < 3; ++j) f.s[j] = mul(scale[j], p.scale_modifier);
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  f.r[0][0] = sub(1.0f, mul(add(mul(y, y), mul(z, z)), 2.0f));
  f.r[0][1] = mul(sub(mul(x, y), mul(z, w)), 2.0f);
  f.r[0][2] = mul(add(mul(x, z), mul(y, w)), 2.0f);
  f.r[1][0] = mul(add(mul(x, y), mul(z, w)), 2.0f);
  f.r[1][1] = sub(1.0f, mul(add(mul(x, x), mul(z, z)), 2.0f));
  f.r[1][2] = mul(sub(mul(y, z), mul(x, w)), 2.0f);
  f.r[2][0] = mul(sub(mul(x, z), mul(y, w)), 2.0f);
  f.r[2][1] = mul(add(mul(y, z), mul(x, w)), 2.0f);
  f.r[2][2] = sub(1.0f, mul(add(mul(x, x), mul(y, y)), 2.0f));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) f.m[i][j] = mul(f.r[i][j], f.s[j]);
  float (&cov)[3][3] = f.cov;
  for (int i = 0; i < 3; ++i)
    for (int k = i; k < 3; ++k)
      cov[i][k] = cov[k][i] = sum3(mul(f.m[i][0], f.m[k][0]),
                                   mul(f.m[i][1], f.m[k][1]),
                                   mul(f.m[i][2], f.m[k][2]));

  // E Sigma E^T (utils/gaussian.py::view_rotate_cov_elems)
  float tmp[3][3], sv[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      tmp[i][k] = sum3(mul(c.e[i][0], cov[0][k]), mul(c.e[i][1], cov[1][k]),
                       mul(c.e[i][2], cov[2][k]));
  for (int i = 0; i < 3; ++i)
    for (int l = i; l < 3; ++l)
      sv[i][l] = sum3(mul(tmp[i][0], c.e[l][0]), mul(tmp[i][1], c.e[l][1]),
                      mul(tmp[i][2], c.e[l][2]));
  f.sv00 = sv[0][0], f.sv01 = sv[0][1], f.sv02 = sv[0][2];
  f.sv11 = sv[1][1], f.sv12 = sv[1][2], f.sv22 = sv[2][2];

  // the linearisation point clamped into the frustum
  f.ux = dvd(f.px, f.sz);
  f.uy = dvd(f.py, f.sz);
  f.cx = clampf(f.ux, -c.lim_x, c.lim_x);
  f.cy = clampf(f.uy, -c.lim_y, c.lim_y);
  f.tx = mul(f.cx, f.sz);
  f.ty = mul(f.cy, f.sz);

  // J Sigma_view J^T (utils/gaussian.py::ewa_project_cov_comps)
  f.inv_z = rcp(f.sz);
  f.inv_z2 = mul(f.inv_z, f.inv_z);
  f.j00 = mul(c.fx, f.inv_z);
  f.j02 = mul(mul(-c.fx, f.tx), f.inv_z2);
  f.j11 = mul(c.fy, f.inv_z);
  f.j12 = mul(mul(-c.fy, f.ty), f.inv_z2);
  float a = add(mul(f.j00, add(mul(f.j00, f.sv00), mul(f.j02, f.sv02))),
                mul(f.j02, add(mul(f.j00, f.sv02), mul(f.j02, f.sv22))));
  f.b = add(mul(f.j00, add(mul(f.j11, f.sv01), mul(f.j12, f.sv02))),
            mul(f.j02, add(mul(f.j11, f.sv12), mul(f.j12, f.sv22))));
  float cc = add(mul(f.j11, add(mul(f.j11, f.sv11), mul(f.j12, f.sv12))),
                 mul(f.j12, add(mul(f.j11, f.sv12), mul(f.j12, f.sv22))));
  f.a_raw = a, f.b_raw = f.b, f.c_raw = cc;
  if (!p.use_focal) {
    a = mul(mul(a, c.k_a), p.nf_a);
    f.b = mul(mul(f.b, c.k_b), p.nf_b);
    cc = mul(mul(cc, c.k_c), p.nf_c);
  }

  // low-pass and invert (utils/gaussian.py::conic_and_radius_comps)
  f.ap = add(a, p.lowpass);
  f.cp = add(cc, p.lowpass);
  const float det = sub(mul(f.ap, f.cp), mul(f.b, f.b));
  f.inv_det = rcp(add(det, p.det_eps));
  f.conic_a = mul(f.cp, f.inv_det);
  f.conic_b = mul(-f.b, f.inv_det);
  f.conic_c = mul(f.ap, f.inv_det);
  return f;
}

// The splat radius in pixels (0 = culled): the 3-sigma bound of the larger
// eigenvalue, shrunk to the exact alpha_min reach with the opacity.
__device__ __forceinline__ int radius_of(const Params& p, const Fwd& f,
                                         const float* opacity) {
  const float det = sub(mul(f.ap, f.cp), mul(f.b, f.b));
  const float mid = mul(add(f.ap, f.cp), 0.5f);
  const float disc = __fsqrt_rn(clamp_min(sub(mul(mid, mid), det), 0.1f));
  const float sq = __fsqrt_rn(add(mid, disc));
  int radius = to_int(ceilf(mul(sq, p.radius_sigma)));
  if (opacity != nullptr) {
    const float o = *opacity;
    float ts = __fsqrt_rn(clamp_min(
        mul(logf(dvd(clamp_min(o, 1e-12f), p.alpha_min)), 2.0f), 0.0f));
    ts = o > p.alpha_min ? ts : 0.0f;
    const int r_t = (int)((unsigned)to_int(ceilf(mul(ts, sq))) + 2u);
    radius = ts > 0.0f ? min(radius, r_t) : 0;
  }
  return f.in_front ? radius : 0;
}

__global__ void __launch_bounds__(kThreads)
projection_forward_kernel(Params p, const float* __restrict__ means,
                          const float* __restrict__ scales,
                          const float* __restrict__ quats,
                          const float* __restrict__ probe,
                          const float* __restrict__ opacities,
                          const bool* __restrict__ active,
                          const float* __restrict__ view,
                          const float* __restrict__ tanx,
                          const float* __restrict__ tany,
                          float* __restrict__ means2d,
                          float* __restrict__ depth, float* __restrict__ conic,
                          int* __restrict__ radius_out,
                          int* __restrict__ rect_min,
                          int* __restrict__ rect_max,
                          int* __restrict__ tiles_touched,
                          bool* __restrict__ valid) {
  __shared__ Camera cam;
  if (threadIdx.x == 0) cam = camera(p, view, tanx, tany);
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= p.n) return;
  const Fwd f = forward_math(p, cam, means + 3 * g, scales + 3 * g,
                             quats + 4 * g);
  float m2x = f.pix_x, m2y = f.pix_y;
  if (probe != nullptr) {
    m2x = add(m2x, probe[2 * g]);
    m2y = add(m2y, probe[2 * g + 1]);
  }
  int radius = radius_of(p, f, opacities != nullptr ? opacities + g : nullptr);
  if (active != nullptr && !active[g]) radius = 0;

  // the tile rect [min, max) (ops/projection.py::_tile_rect)
  const float r = (float)radius;
  const float tw = (float)p.tile_w, th = (float)p.tile_h;
  const int lo_x = to_int(floorf(mul(sub(m2x, r), cam.inv_tw)));
  const int lo_y = to_int(floorf(mul(sub(m2y, r), cam.inv_th)));
  const int hi_x = to_int(floorf(mul(sub(add(add(m2x, r), tw), 1.0f),
                                     cam.inv_tw)));
  const int hi_y = to_int(floorf(mul(sub(add(add(m2y, r), th), 1.0f),
                                     cam.inv_th)));
  const int x0 = min(max(lo_x, 0), p.grid_x - 1);
  const int y0 = min(max(lo_y, 0), p.grid_y - 1);
  const int x1 = min(max(hi_x, 0), p.max_x);
  const int y1 = min(max(hi_y, 0), p.max_y);
  const int tiles = radius > 0 ? max(x1 - x0, 0) * max(y1 - y0, 0) : 0;

  means2d[2 * g] = m2x;
  means2d[2 * g + 1] = m2y;
  depth[g] = f.depth;
  conic[3 * g] = f.conic_a;
  conic[3 * g + 1] = f.conic_b;
  conic[3 * g + 2] = f.conic_c;
  radius_out[g] = radius;
  rect_min[2 * g] = x0;
  rect_min[2 * g + 1] = y0;
  rect_max[2 * g] = x1;
  rect_max[2 * g + 1] = y1;
  tiles_touched[g] = tiles;
  valid[g] = tiles > 0;
}

// The number of per-gaussian camera terms: rows 0-2 of d view, then d tan_x
// and d tan_y.
constexpr int kCamTerms = 14;

// The backward of one gaussian: d means, d scales, d quats from the centre's
// (gx, gy) and the conic's (ga, gb, gc) cotangents; with kCam also this
// gaussian's share of the camera's gradient, d_cam[kCamTerms].
template <bool kCam>
__device__ __forceinline__ void backward_math(const Params& p,
                                              const Camera& c, const Fwd& f,
                                              float gx, float gy, float ga,
                                              float gb, float gc,
                                              const float* q,
                                              const float* mean,
                                              float* d_mean, float* d_scale,
                                              float* d_quat, float* d_cam) {
  float d_tan_x = 0.0f, d_tan_y = 0.0f;

  // conic = (c', -b, a') / (a' c' - b^2 + det_eps)
  const float d_inv = ga * f.cp - gb * f.b + gc * f.ap;
  const float d_det = -d_inv * f.inv_det * f.inv_det;
  float da = gc * f.inv_det + d_det * f.cp;
  float db = -gb * f.inv_det - 2.0f * f.b * d_det;
  float dc = ga * f.inv_det + d_det * f.ap;
  if (!p.use_focal) {
    if (kCam) {
      // a = a_raw k_a nf_a with k_a = 1 / (tan_x tan_x), k_b = 1 / (tan_x
      // tan_y), k_c = 1 / (tan_y tan_y)
      const float dka = da * f.a_raw * p.nf_a * c.k_a * c.k_a;
      const float dkb = db * f.b_raw * p.nf_b * c.k_b * c.k_b;
      const float dkc = dc * f.c_raw * p.nf_c * c.k_c * c.k_c;
      d_tan_x -= 2.0f * dka * c.tan_x + dkb * c.tan_y;
      d_tan_y -= dkb * c.tan_x + 2.0f * dkc * c.tan_y;
    }
    da = da * p.nf_a * c.k_a;
    db = db * p.nf_b * c.k_b;
    dc = dc * p.nf_c * c.k_c;
  }

  // (a, b, c) = J Sigma_view J^T: to the six covariance elements and J
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  const float s00 = f.sv00, s01 = f.sv01, s02 = f.sv02;
  const float s11 = f.sv11, s12 = f.sv12, s22 = f.sv22;
  const float ds00 = da * j00 * j00;
  const float ds01 = db * j00 * j11;
  const float ds02 = 2.0f * da * j00 * j02 + db * j00 * j12;
  const float ds11 = dc * j11 * j11;
  const float ds12 = db * j02 * j11 + 2.0f * dc * j11 * j12;
  const float ds22 = da * j02 * j02 + db * j02 * j12 + dc * j12 * j12;
  const float dj00 = 2.0f * da * (j00 * s00 + j02 * s02) +
                     db * (j11 * s01 + j12 * s02);
  const float dj02 = 2.0f * da * (j00 * s02 + j02 * s22) +
                     db * (j11 * s12 + j12 * s22);
  const float dj11 = db * (j00 * s01 + j02 * s12) +
                     2.0f * dc * (j11 * s11 + j12 * s12);
  const float dj12 = db * (j00 * s02 + j02 * s22) +
                     2.0f * dc * (j11 * s12 + j12 * s22);

  // J: j00 = fx / z, j02 = -fx tx / z^2, j11 = fy / z, j12 = -fy ty / z^2;
  // fx = W / (2 tan_x) on the focal path
  const float d_inv_z2 = dj02 * (-c.fx * f.tx) + dj12 * (-c.fy * f.ty);
  const float d_inv_z = dj00 * c.fx + dj11 * c.fy + 2.0f * f.inv_z * d_inv_z2;
  const float d_tx = -c.fx * dj02 * f.inv_z2;
  const float d_ty = -c.fy * dj12 * f.inv_z2;
  float d_sz = -d_inv_z * f.inv_z * f.inv_z;
  if (kCam && p.use_focal) {
    const float d_fx = dj00 * f.inv_z - dj02 * f.tx * f.inv_z2;
    const float d_fy = dj11 * f.inv_z - dj12 * f.ty * f.inv_z2;
    d_tan_x -= d_fx * c.fx / c.tan_x;
    d_tan_y -= d_fy * c.fy / c.tan_y;
  }

  // t = clamp(p / z, -lim, lim) * z, lim = frustum_clamp * tan: the point
  // takes the gradient inside the clamp and at its ends, lim outside
  d_sz += d_tx * f.cx + d_ty * f.cy;
  const float d_cx = d_tx * f.sz, d_cy = d_ty * f.sz;
  const float d_ux = f.ux >= -c.lim_x && f.ux <= c.lim_x ? d_cx : 0.0f;
  const float d_uy = f.uy >= -c.lim_y && f.uy <= c.lim_y ? d_cy : 0.0f;
  if (kCam) {
    const float d_lim_x = f.ux > c.lim_x ? d_cx : f.ux < -c.lim_x ? -d_cx : 0.0f;
    const float d_lim_y = f.uy > c.lim_y ? d_cy : f.uy < -c.lim_y ? -d_cy : 0.0f;
    d_tan_x += d_lim_x * p.frustum_clamp;
    d_tan_y += d_lim_y * p.frustum_clamp;
  }
  float d_px = d_ux / f.sz;
  float d_py = d_uy / f.sz;
  d_sz -= d_ux * (f.ux / f.sz) + d_uy * (f.uy / f.sz);

  // pix = ((p / tan * inv_w + 1) W - 1) / 2, inv_w = 1 / (z + w_eps)
  const float d_nx = gx * 0.5f * (float)p.width;
  const float d_ny = gy * 0.5f * (float)p.height;
  d_px += d_nx * f.inv_w / c.tan_x;
  d_py += d_ny * f.inv_w / c.tan_y;
  if (kCam) {
    d_tan_x -= d_nx * f.inv_w * f.qx / c.tan_x;
    d_tan_y -= d_ny * f.inv_w * f.qy / c.tan_y;
  }
  const float d_inv_w = d_nx * f.qx + d_ny * f.qy;
  d_sz -= d_inv_w * f.inv_w * f.inv_w;
  const float d_depth = f.in_front ? d_sz : 0.0f;
  for (int j = 0; j < 3; ++j)
    d_mean[j] = c.v[0][j] * d_px + c.v[1][j] * d_py + c.v[2][j] * d_depth;

  // Sigma_view = E Sigma E^T over symmetric element tensors: with H the
  // symmetric matrix of the element gradients (off-diagonal halved), G =
  // E^T H E, and Sigma = M M^T gives dM = 2 G M
  const float h[3][3] = {{ds00, 0.5f * ds01, 0.5f * ds02},
                         {0.5f * ds01, ds11, 0.5f * ds12},
                         {0.5f * ds02, 0.5f * ds12, ds22}};
  float he[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      he[i][k] = h[i][0] * c.e[0][k] + h[i][1] * c.e[1][k] +
                 h[i][2] * c.e[2][k];
  if (kCam) {
    // p = V[:3, :3] mean + V[:3, 3], and dE = 2 H E Sigma: to the view,
    // transposed where E is view3's transpose ("lcgs")
    const float dp[3] = {d_px, d_py, d_depth};
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) d_cam[4 * i + j] = dp[i] * mean[j];
      d_cam[4 * i + 3] = dp[i];
    }
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) {
        const float de = 2.0f * (he[i][0] * f.cov[0][k] +
                                 he[i][1] * f.cov[1][k] +
                                 he[i][2] * f.cov[2][k]);
        d_cam[p.ewa_lcgs ? 4 * k + i : 4 * i + k] += de;
      }
    d_cam[12] = d_tan_x;
    d_cam[13] = d_tan_y;
  }
  float gm[3][3];
  for (int j = 0; j < 3; ++j)
    for (int k = j; k < 3; ++k)
      gm[j][k] = gm[k][j] = c.e[0][j] * he[0][k] + c.e[1][j] * he[1][k] +
                            c.e[2][j] * he[2][k];
  float dr[3][3];
  float ds[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float dm = 2.0f * (gm[i][0] * f.m[0][j] + gm[i][1] * f.m[1][j] +
                               gm[i][2] * f.m[2][j]);
      dr[i][j] = dm * f.s[j];
      ds[j] += dm * f.r[i][j];
    }
  for (int j = 0; j < 3; ++j) d_scale[j] = ds[j] * p.scale_modifier;

  // the rotation of the (x, y, z, w) quaternion (utils/gaussian.py
  // rotation_elems)
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  d_quat[0] = 2.0f * (y * (dr[0][1] + dr[1][0]) + z * (dr[0][2] + dr[2][0]) +
                      w * (dr[2][1] - dr[1][2])) -
              4.0f * x * (dr[1][1] + dr[2][2]);
  d_quat[1] = 2.0f * (x * (dr[0][1] + dr[1][0]) + w * (dr[0][2] - dr[2][0]) +
                      z * (dr[1][2] + dr[2][1])) -
              4.0f * y * (dr[0][0] + dr[2][2]);
  d_quat[2] = 2.0f * (w * (dr[1][0] - dr[0][1]) + x * (dr[0][2] + dr[2][0]) +
                      y * (dr[1][2] + dr[2][1])) -
              4.0f * z * (dr[0][0] + dr[1][1]);
  d_quat[3] = 2.0f * (z * (dr[1][0] - dr[0][1]) + y * (dr[0][2] - dr[2][0]) +
                      x * (dr[2][1] - dr[1][2]));
}

// d_cam, where given, is (kCamTerms, n): one gaussian's terms a column
template <bool kCam>
__global__ void __launch_bounds__(kThreads)
projection_backward_kernel(Params p, const float* __restrict__ means,
                           const float* __restrict__ scales,
                           const float* __restrict__ quats,
                           const float* __restrict__ view,
                           const float* __restrict__ tanx,
                           const float* __restrict__ tany,
                           const float* __restrict__ d_means2d, int64_t m_s0,
                           int64_t m_s1, const float* __restrict__ d_conic,
                           int64_t c_s0, int64_t c_s1,
                           float* __restrict__ d_means,
                           float* __restrict__ d_scales,
                           float* __restrict__ d_quats,
                           float* __restrict__ d_cam) {
  __shared__ Camera cam;
  if (threadIdx.x == 0) cam = camera(p, view, tanx, tany);
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= p.n) return;
  const float* q = quats + 4 * g;
  const float* mean = means + 3 * g;
  const Fwd f = forward_math(p, cam, mean, scales + 3 * g, q);
  float gx = 0.0f, gy = 0.0f, ga = 0.0f, gb = 0.0f, gc = 0.0f;
  if (d_means2d != nullptr) {
    gx = d_means2d[g * m_s0];
    gy = d_means2d[g * m_s0 + m_s1];
  }
  if (d_conic != nullptr) {
    ga = d_conic[g * c_s0];
    gb = d_conic[g * c_s0 + c_s1];
    gc = d_conic[g * c_s0 + 2 * c_s1];
  }
  float dm[3], dsc[3], dq[4], dcam[kCamTerms];
  backward_math<kCam>(p, cam, f, gx, gy, ga, gb, gc, q, mean, dm, dsc, dq,
                      dcam);
  for (int j = 0; j < 3; ++j) {
    d_means[3 * g + j] = dm[j];
    d_scales[3 * g + j] = dsc[j];
  }
  for (int j = 0; j < 4; ++j) d_quats[4 * g + j] = dq[j];
  if (kCam)
    for (int k = 0; k < kCamTerms; ++k) d_cam[k * p.n + g] = dcam[k];
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

bool valid_params(const Params* p) {
  return p->n >= 0 && p->n <= (int64_t)kThreads * 0x7fffffff &&
         p->tile_w > 0 && p->tile_h > 0 && p->grid_x > 0 && p->grid_y > 0;
}

}  // namespace

// The eight ProjectedGaussians fields, all contiguous on the device: means2d
// (n, 2), depth (n,), conic (n, 3) float32; radius (n,), rect_min (n, 2),
// rect_max (n, 2), tiles_touched (n,) int32; valid (n,) bool. The inputs:
// means (n, 3), scales (n, 3), quats (n, 4), view (4, 4), tanx and tany
// (one float each) float32; probe (n, 2) float32, opacities (n,) float32 and
// active (n,) bool may be null.
extern "C" int projection_forward_launch(
    const Params* p, const float* means, const float* scales,
    const float* quats, const float* probe, const float* opacities,
    const bool* active, const float* view, const float* tanx,
    const float* tany, float* means2d, float* depth, float* conic, int* radius,
    int* rect_min, int* rect_max, int* tiles_touched, bool* valid,
    cudaStream_t stream) {
  if (!valid_params(p)) return (int)cudaErrorInvalidValue;
  if (p->n == 0) return 0;
  projection_forward_kernel<<<blocks(p->n), kThreads, 0, stream>>>(
      *p, means, scales, quats, probe, opacities, active, view, tanx, tany,
      means2d, depth, conic, radius, rect_min, rect_max, tiles_touched, valid);
  return (int)cudaGetLastError();
}

// d_means (n, 3), d_scales (n, 3), d_quats (n, 4) from the forward's inputs
// and the cotangents, each of any strides (element [g, c] at
// ptr[g * s0 + c * s1]) or null for none: d_means2d (n, 2), d_conic (n, 3).
// d_cam (14, n), where not null, takes each gaussian's terms of the camera's
// gradient: rows 0-2 of d view (row-major), d tan_x, d tan_y.
extern "C" int projection_backward_launch(
    const Params* p, const float* means, const float* scales,
    const float* quats, const float* view, const float* tanx,
    const float* tany, const float* d_means2d, int64_t m_s0, int64_t m_s1,
    const float* d_conic, int64_t c_s0, int64_t c_s1, float* d_means,
    float* d_scales, float* d_quats, float* d_cam, cudaStream_t stream) {
  if (!valid_params(p)) return (int)cudaErrorInvalidValue;
  if (p->n == 0) return 0;
  if (d_cam != nullptr)
    projection_backward_kernel<true><<<blocks(p->n), kThreads, 0, stream>>>(
        *p, means, scales, quats, view, tanx, tany, d_means2d, m_s0, m_s1,
        d_conic, c_s0, c_s1, d_means, d_scales, d_quats, d_cam);
  else
    projection_backward_kernel<false><<<blocks(p->n), kThreads, 0, stream>>>(
        *p, means, scales, quats, view, tanx, tany, d_means2d, m_s0, m_s1,
        d_conic, c_s0, c_s1, d_means, d_scales, d_quats, d_cam);
  return (int)cudaGetLastError();
}
