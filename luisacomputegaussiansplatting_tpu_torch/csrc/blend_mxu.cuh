// blend_quad="mxu": the power of an (entry, pixel) pair as the JAX kernels
// evaluate it (luisacomputegaussiansplatting_tpu/ops/rasterize_pallas.py
// `_chunk_blend`, blend_quad="mxu"). Shared by rasterize.cu and
// rasterize_backward.cu, so that the forward and the backward blend make the
// same keep and stop decisions.
//
// power' = power + ln(opacity) is a quadratic in the tile-local pixel
// (xl, yl) = (x - tile x0, y - tile y0):
//   power' = a0 + bx xl + by yl - ca/2 xl^2 - cc/2 yl^2 - cb xl yl,
// with the entry's tile-local mean (mxl, myl) in
//   a0 = -0.5 (ca mxl^2 + cc myl^2) - cb mxl myl + ln(opacity),
//   bx = ca mxl + cb myl,  by = cc myl + cb mxl.
// alpha = exp(power'), and the entry is kept while
// power' <= ln(opacity) + POWER_GUARD. The TPU contracts the pixel basis
// with the coefficients on its MXU; here the coefficients are computed once
// per entry (mxu_coefficients) and each pixel thread evaluates the
// polynomial in plain FP32, 5 multiplies and 5 adds a pair (mxu_power).
// Every op is spelled with a round-to-nearest intrinsic in the order of the
// plain version (ops/rasterize_ref.py::_mxu_alpha), which eager PyTorch
// rounds op by op: no multiply-add may be contracted into an FMA, or a
// power' near the guard limit would be kept by one and dropped by the other.
#pragma once

#include <cuda_runtime.h>

// rows of coefficients per entry: a0, bx, by, -ca/2, -cc/2, -cb, and the
// guard limit ln(opacity) + POWER_GUARD
constexpr int kMxuCoefs = 7;

// The coefficients of one entry into c[0], c[stride], ..., c[6 * stride].
__device__ __forceinline__ void mxu_coefficients(float mx, float my, float ca,
                                                 float cb, float cc, float op,
                                                 float tx0, float ty0,
                                                 float power_guard, float* c,
                                                 int stride) {
  const float mxl = __fsub_rn(mx, tx0);
  const float myl = __fsub_rn(my, ty0);
  // the clamp keeps padding (opacity 0) finite: alpha ~ 1e-30
  const float ln_op = logf(fmaxf(op, 1e-30f));
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(ca, mxl), mxl),
                            __fmul_rn(__fmul_rn(cc, myl), myl));
  c[0] = __fadd_rn(
      __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(cb, mxl), myl)),
      ln_op);
  c[stride] = __fadd_rn(__fmul_rn(ca, mxl), __fmul_rn(cb, myl));
  c[2 * stride] = __fadd_rn(__fmul_rn(cc, myl), __fmul_rn(cb, mxl));
  c[3 * stride] = __fmul_rn(-0.5f, ca);
  c[4 * stride] = __fmul_rn(-0.5f, cc);
  c[5 * stride] = -cb;
  c[6 * stride] = __fadd_rn(ln_op, power_guard);
}

// The per-pixel basis: tile-local x, y, x^2, y^2, x y (small integers,
// exact in FP32).
struct MxuBasis {
  float xl, yl, xl2, yl2, xlyl;
};

__device__ __forceinline__ MxuBasis mxu_basis(int p, int tile_w) {
  const float xl = (float)(p % tile_w), yl = (float)(p / tile_w);
  return {xl, yl, __fmul_rn(xl, xl), __fmul_rn(yl, yl), __fmul_rn(xl, yl)};
}

// power' of the entry whose coefficients start at c (row stride ``stride``).
__device__ __forceinline__ float mxu_power(const float* c, int stride,
                                           const MxuBasis& u) {
  float pw = __fadd_rn(c[0], __fmul_rn(c[stride], u.xl));
  pw = __fadd_rn(pw, __fmul_rn(c[2 * stride], u.yl));
  pw = __fadd_rn(pw, __fmul_rn(c[3 * stride], u.xl2));
  pw = __fadd_rn(pw, __fmul_rn(c[4 * stride], u.yl2));
  return __fadd_rn(pw, __fmul_rn(c[5 * stride], u.xlyl));
}
