// SH colours (K5): rgb = clamp(0.5 + sum_i Y_i(dir) sh[i], 0, 1) with dir =
// normalize(mean - cam_pos), and its backward to the means and coefficients.
//
// Replaces no TPU kernel. The JAX package's ops/sh_eval.py is plain jnp code
// that XLA fuses into one pass. PyTorch's eager ops do not fuse: the plain
// version (utils/sh.py::eval_sh_color over the 48 strided coefficient
// columns) costs 166 launches forward and 272 backward a step, most on
// torch's non-vectorised strided path: 25.3 ms a training step at 6M
// gaussians on an H100. This pair does the same function in one launch
// each way.
//
// What bounds it on the card: device memory. Per gaussian at degree 3, in
// f32, the forward reads the mean (12 B) and 16 x 3 coefficients (192 B) and
// writes RGB (12 B): 216 B. The backward reads dRGB (12 B), the mean and the
// coefficients, and writes dSH (192 B) and d mean (12 B): 420 B. About 150
// FP32 operations a gaussian each way are ~0.01 ms at 6M against 0.39 ms
// (forward) and 0.75 ms (backward) of bytes at 3.35 TB/s.
//
// Design: a block owns kThreads consecutive gaussians, whose coefficient
// rows are one contiguous span of memory. The block stages that span through
// shared memory with 16-byte loads, neighbouring threads on neighbouring
// addresses, so every sector fetched is used whole; a thread then reads its
// own row from shared memory. Rows lie in shared memory at an odd stride
// (49 floats at degree 3), so the 32 threads of a warp reading their rows'
// element j hit 32 different banks (a 48-float stride would put them on 2).
// The backward overwrites each staged row with its dSH and writes the span
// back the same way. The mean, cam_pos and the 3-float outputs are read and
// written by each thread directly (12-byte records, merged in L1 and L2).
// 25 KB of shared memory a block lets 8 blocks share an SM, ~200 KB of
// loads in flight an SM, enough to cover the memory's latency.
//
// The degree (0-3) is a template parameter; K_tot >= (degree + 1)^2, the
// coefficient count of a row, is a runtime stride, so a degree schedule over
// a K_tot = 16 tensor runs here too. Coefficients past the degree are read
// with the span but never staged, and their dSH is written as exact zeros.
//
// The forward must equal the plain version bit for bit, so every product
// and sum is written with round-to-nearest intrinsics (no FMA contraction)
// in the plain version's order, the constants are the float32 roundings of
// its Python doubles, the norm is an IEEE sqrt and the inverse an IEEE
// division (torch evaluates `1.0 / t` as reciprocal(t) * 1.0). The backward
// recomputes the direction, the basis and the pre-clamp sums from the inputs
// with the same code, so its clamp mask is the forward's; its gradient
// arithmetic may round differently from autograd's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// float32 roundings of the Python doubles of utils/sh.py
constexpr float kC0 = (float)0.28209479177387814;
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC2_0 = (float)1.0925484305920792;
constexpr float kC2_1 = (float)-1.0925484305920792;
constexpr float kC2_2 = (float)0.31539156525252005;
constexpr float kC2_3 = (float)-1.0925484305920792;
constexpr float kC2_4 = (float)0.5462742152960396;
constexpr float kC3_0 = (float)-0.5900435899266435;
constexpr float kC3_1 = (float)2.890611442640554;
constexpr float kC3_2 = (float)-0.4570457994644658;
constexpr float kC3_3 = (float)0.3731763325901154;
constexpr float kC3_4 = (float)-0.4570457994644658;
constexpr float kC3_5 = (float)1.445305721320277;
constexpr float kC3_6 = (float)-0.5900435899266435;
// clamp(min=1e-12) of ops/sh_eval.py, as torch casts the scalar
constexpr float kNormMin = (float)1e-12;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int D>
struct Sh {
  static constexpr int K = (D + 1) * (D + 1);  // coefficients used
  static constexpr int M = 3 * K;               // floats of a row used
  static constexpr int S = M | 1;               // odd shared-memory stride
};

// Stage rows [g0, g0 + n_rows) of `sh` (row_floats floats a row) into
// tile[r * S + c], c < M; every thread of the block takes part.
template <int M, int S>
__device__ __forceinline__ void stage_rows(const float* __restrict__ sh,
                                           int64_t g0, int n_rows,
                                           int row_floats,
                                           float* __restrict__ tile) {
  const float* src = sh + g0 * row_floats;
  const int n = n_rows * row_floats;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = __ldg(src4 + i);
      const float vals[4] = {v.x, v.y, v.z, v.w};
      int r = (4 * i) / row_floats, c = 4 * i - r * row_floats;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c < M) tile[r * S + c] = vals[j];
        if (++c == row_floats) c = 0, ++r;
      }
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < n; e += kThreads) {
    const int r = e / row_floats, c = e - r * row_floats;
    if (c < M) tile[r * S + c] = __ldg(src + e);
  }
}

// Write tile[r * S + c] (zero for c >= M) to rows [g0, g0 + n_rows) of out.
template <int M, int S>
__device__ __forceinline__ void store_rows(const float* __restrict__ tile,
                                           int64_t g0, int n_rows,
                                           int row_floats,
                                           float* __restrict__ out) {
  float* dst = out + g0 * row_floats;
  const int n = n_rows * row_floats;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float vals[4];
      int r = (4 * i) / row_floats, c = 4 * i - r * row_floats;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vals[j] = c < M ? tile[r * S + c] : 0.0f;
        if (++c == row_floats) c = 0, ++r;
      }
      dst4[i] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < n; e += kThreads) {
    const int r = e / row_floats, c = e - r * row_floats;
    dst[e] = c < M ? tile[r * S + c] : 0.0f;
  }
}

// The direction of ops/sh_eval.py::compute_colors: d = mean - cam, the
// clamped norm and its inverse, dir = d * inv.
struct Dir {
  float dx, dy, dz, norm, inv, x, y, z;
};

__device__ __forceinline__ Dir direction(const float* __restrict__ means,
                                         const float* __restrict__ cam,
                                         int64_t g) {
  Dir d;
  d.dx = sub(means[3 * g], __ldg(cam));
  d.dy = sub(means[3 * g + 1], __ldg(cam + 1));
  d.dz = sub(means[3 * g + 2], __ldg(cam + 2));
  d.norm = __fsqrt_rn(add(add(mul(d.dx, d.dx), mul(d.dy, d.dy)),
                          mul(d.dz, d.dz)));
  // torch.clamp: NaN stays NaN
  const float c = d.norm < kNormMin ? kNormMin : d.norm;
  d.inv = __fdiv_rn(1.0f, c);
  d.x = mul(d.dx, d.inv);
  d.y = mul(d.dy, d.inv);
  d.z = mul(d.dz, d.inv);
  return d;
}

// utils/sh.py::sh_basis_comps, in its expression order
template <int D>
__device__ __forceinline__ void basis(float x, float y, float z, float* Y) {
  Y[0] = kC0;
  if constexpr (D >= 1) {
    Y[1] = mul(-kC1, y);
    Y[2] = mul(kC1, z);
    Y[3] = mul(-kC1, x);
  }
  if constexpr (D >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), zx = mul(z, x);
    Y[4] = mul(kC2_0, xy);
    Y[5] = mul(kC2_1, yz);
    Y[6] = mul(kC2_2, sub(sub(mul(2.0f, zz), xx), yy));
    Y[7] = mul(kC2_3, zx);
    Y[8] = mul(kC2_4, sub(xx, yy));
    if constexpr (D >= 3) {
      Y[9] = mul(mul(kC3_0, y), sub(mul(3.0f, xx), yy));
      Y[10] = mul(mul(kC3_1, xy), z);
      Y[11] = mul(mul(kC3_2, y), sub(sub(mul(4.0f, zz), xx), yy));
      Y[12] = mul(mul(kC3_3, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      Y[13] = mul(mul(kC3_4, x), sub(sub(mul(4.0f, zz), xx), yy));
      Y[14] = mul(mul(kC3_5, z), sub(xx, yy));
      Y[15] = mul(mul(kC3_6, x), sub(xx, mul(3.0f, yy)));
    }
  }
}

// acc = 0.5; acc += Y_i * row[3 i + c], left to right (utils/sh.py)
template <int K>
__device__ __forceinline__ float accumulate(const float* Y, const float* row,
                                            int c) {
  float acc = add(0.5f, mul(Y[0], row[c]));
#pragma unroll
  for (int i = 1; i < K; ++i) acc = add(acc, mul(Y[i], row[3 * i + c]));
  return acc;
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sh_forward_kernel(const float* __restrict__ means, const float* __restrict__ sh,
                  const float* __restrict__ cam, int64_t n, int row_floats,
                  float* __restrict__ rgb) {
  using T = Sh<D>;
  __shared__ float tile[kThreads * T::S];
  const int64_t g0 = (int64_t)blockIdx.x * kThreads;
  const int rows = n - g0 < kThreads ? (int)(n - g0) : kThreads;
  stage_rows<T::M, T::S>(sh, g0, rows, row_floats, tile);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  const int64_t g = g0 + t;
  const Dir d = direction(means, cam, g);
  float Y[T::K];
  basis<D>(d.x, d.y, d.z, Y);
  const float* row = tile + t * T::S;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[3 * g + c] = clamp01(accumulate<T::K>(Y, row, c));
}

// d(basis)/d(dir) . dY (the derivatives of utils/sh.py's polynomials)
template <int D>
__device__ __forceinline__ void basis_backward(float x, float y, float z,
                                               const float* dY, float& gx,
                                               float& gy, float& gz) {
  gx = gy = gz = 0.0f;
  if constexpr (D >= 1) {
    gx -= kC1 * dY[3];
    gy -= kC1 * dY[1];
    gz += kC1 * dY[2];
  }
  if constexpr (D >= 2) {
    gx += kC2_0 * y * dY[4] - 2.0f * kC2_2 * x * dY[6] + kC2_3 * z * dY[7] +
          2.0f * kC2_4 * x * dY[8];
    gy += kC2_0 * x * dY[4] + kC2_1 * z * dY[5] - 2.0f * kC2_2 * y * dY[6] -
          2.0f * kC2_4 * y * dY[8];
    gz += kC2_1 * y * dY[5] + 4.0f * kC2_2 * z * dY[6] + kC2_3 * x * dY[7];
  }
  if constexpr (D >= 3) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += kC3_0 * 6.0f * x * y * dY[9] + kC3_1 * y * z * dY[10] -
          kC3_2 * 2.0f * x * y * dY[11] - kC3_3 * 6.0f * x * z * dY[12] +
          kC3_4 * (4.0f * zz - 3.0f * xx - yy) * dY[13] +
          kC3_5 * 2.0f * x * z * dY[14] + kC3_6 * 3.0f * (xx - yy) * dY[15];
    gy += kC3_0 * 3.0f * (xx - yy) * dY[9] + kC3_1 * x * z * dY[10] +
          kC3_2 * (4.0f * zz - xx - 3.0f * yy) * dY[11] -
          kC3_3 * 6.0f * y * z * dY[12] - kC3_4 * 2.0f * x * y * dY[13] -
          kC3_5 * 2.0f * y * z * dY[14] - kC3_6 * 6.0f * x * y * dY[15];
    gz += kC3_1 * x * y * dY[10] + kC3_2 * 8.0f * y * z * dY[11] +
          kC3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * dY[12] +
          kC3_4 * 8.0f * x * z * dY[13] + kC3_5 * (xx - yy) * dY[14];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sh_backward_kernel(const float* __restrict__ means,
                   const float* __restrict__ sh, const float* __restrict__ cam,
                   int64_t n, int row_floats, const float* __restrict__ d_rgb,
                   int64_t d_rgb_s0, int64_t d_rgb_s1, float* __restrict__ d_sh,
                   float* __restrict__ d_means) {
  using T = Sh<D>;
  __shared__ float tile[kThreads * T::S];
  const int64_t g0 = (int64_t)blockIdx.x * kThreads;
  const int rows = n - g0 < kThreads ? (int)(n - g0) : kThreads;
  stage_rows<T::M, T::S>(sh, g0, rows, row_floats, tile);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int64_t g = g0 + t;
    const Dir d = direction(means, cam, g);
    float Y[T::K];
    basis<D>(d.x, d.y, d.z, Y);
    float* row = tile + t * T::S;
    // torch's clamp backward: the gradient passes where 0 <= acc <= 1
    float gc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float acc = accumulate<T::K>(Y, row, c);
      gc[c] = acc >= 0.0f && acc <= 1.0f ? d_rgb[g * d_rgb_s0 + c * d_rgb_s1]
                                         : 0.0f;
    }
    float dY[T::K];
#pragma unroll
    for (int i = 0; i < T::K; ++i) {
      dY[i] = gc[0] * row[3 * i] + gc[1] * row[3 * i + 1] +
              gc[2] * row[3 * i + 2];
      // the row is this thread's alone: its dSH replaces it
#pragma unroll
      for (int c = 0; c < 3; ++c) row[3 * i + c] = Y[i] * gc[c];
    }
    float gx, gy, gz;
    basis_backward<D>(d.x, d.y, d.z, dY, gx, gy, gz);
    // through dir = d * inv, inv = 1 / clamp(sqrt(|d|^2), min=1e-12), as
    // autograd chains it: the clamp passes where norm >= 1e-12, and the
    // sqrt's 0 / (2 norm) is NaN for a gaussian at the camera
    const float d_inv = gx * d.dx + gy * d.dy + gz * d.dz;
    const float d_norm = d.norm >= kNormMin ? -d_inv * (d.inv * d.inv) : 0.0f;
    const float d_sq = d_norm / (2.0f * d.norm);
    d_means[3 * g] = gx * d.inv + 2.0f * d.dx * d_sq;
    d_means[3 * g + 1] = gy * d.inv + 2.0f * d.dy * d_sq;
    d_means[3 * g + 2] = gz * d.inv + 2.0f * d.dz * d_sq;
  }
  __syncthreads();
  store_rows<T::M, T::S>(tile, g0, rows, row_floats, d_sh);
}

bool valid(int64_t n, int k_tot, int degree) {
  return n >= 0 && degree >= 0 && degree <= 3 &&
         k_tot >= (degree + 1) * (degree + 1) && k_tot <= (1 << 20);
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <int D>
void forward(const float* means, const float* sh, const float* cam, int64_t n,
             int k_tot, float* rgb, cudaStream_t stream) {
  sh_forward_kernel<D><<<blocks(n), kThreads, 0, stream>>>(
      means, sh, cam, n, 3 * k_tot, rgb);
}

template <int D>
void backward(const float* means, const float* sh, const float* cam,
              int64_t n, int k_tot, const float* d_rgb, int64_t s0,
              int64_t s1, float* d_sh, float* d_means, cudaStream_t stream) {
  sh_backward_kernel<D><<<blocks(n), kThreads, 0, stream>>>(
      means, sh, cam, n, 3 * k_tot, d_rgb, s0, s1, d_sh, d_means);
}

}  // namespace

// rgb (n, 3) from means (n, 3), sh (n, k_tot, 3) and cam (3,), all float32
// and contiguous on the device.
extern "C" int sh_forward_launch(const float* means, const float* sh,
                                 const float* cam, int64_t n, int k_tot,
                                 int degree, float* rgb, cudaStream_t stream) {
  if (!valid(n, k_tot, degree)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto launch = degree == 0 ? forward<0> : degree == 1 ? forward<1>
              : degree == 2 ? forward<2> : forward<3>;
  launch(means, sh, cam, n, k_tot, rgb, stream);
  return (int)cudaGetLastError();
}

// d_sh (n, k_tot, 3) and d_means (n, 3) from the forward's inputs and d_rgb
// (element [g, c] at d_rgb[g * s0 + c * s1]).
extern "C" int sh_backward_launch(const float* means, const float* sh,
                                  const float* cam, int64_t n, int k_tot,
                                  int degree, const float* d_rgb, int64_t s0,
                                  int64_t s1, float* d_sh, float* d_means,
                                  cudaStream_t stream) {
  if (!valid(n, k_tot, degree)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto launch = degree == 0 ? backward<0> : degree == 1 ? backward<1>
              : degree == 2 ? backward<2> : backward<3>;
  launch(means, sh, cam, n, k_tot, d_rgb, s0, s1, d_sh, d_means, stream);
  return (int)cudaGetLastError();
}
