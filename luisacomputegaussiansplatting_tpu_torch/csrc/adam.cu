// Adam (K7): the whole update of every parameter group in one launch and one
// pass over each element,
//
//   m += (1 - b1) (g - m)
//   v  = v b2 + (1 - b2) g g
//   p += (-lr / bc1) m / (sqrt(v) / sqrt(bc2) + eps)
//
// with bc1 = 1 - b1^t and bc2 = 1 - b2^t computed on the host in double from
// each parameter's step t, as torch.optim.Adam's non-capturable path does.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax's Adam, which
// XLA fuses into one pass. torch.optim.Adam's default (foreach) path runs
// seven passes a parameter group (lerp_, mul_, addcmul_, sqrt, div_, add_,
// addcdiv_): 72 B an element, 9.65 ms a step over the 354M floats of a
// 6M-gaussian scene on an H100.
//
// What bounds it on the card: device memory. Per element it reads p, g, m
// and v and writes p, m and v: 28 B, 9.9 GB a step at 6M gaussians, 2.96 ms
// at 3.35 TB/s. About 11 FP32 operations an element are ~0.06 ms.
//
// Design: one grid over all the tensors of a step. The host lays each
// tensor's blocks after the previous tensor's in a by-value table (pointers,
// element count, first block, the group's scalars); a block finds its
// tensor by a scan of the table, which lies in the kernel's parameter space.
// Each tensor is walked in float4 units (16-byte loads and stores,
// neighbouring threads on neighbouring addresses; the wrapper takes only
// 16-byte aligned arrays) and the thread that owns its last, partial unit
// updates the 1-3 floats left one by one. Each thread keeps kUnroll units of
// each array in flight before it computes.
//
// Rounding follows torch's foreach kernels op for op (nvcc contracts their
// `a + s * b` into an FMA): the lerp as fma(1 - b1, g - m, m), the second
// moment as fma(1 - b2, g * g, v * b2), an IEEE sqrt and IEEE divisions, and
// the parameter as fma(-lr / bc1, m / d, p); the group's scalars are the
// float32 roundings of the host's doubles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // units of each array a thread loads before use
constexpr int kIters = 4;   // such rounds a thread makes
constexpr int64_t kUnitsPerBlock = (int64_t)kThreads * kUnroll * kIters;
constexpr int kMaxTensors = 16;

struct Tensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;            // elements
  int64_t first_block;  // the grid's first block over this tensor
  float step_size;      // -lr / bc1
  float bc2_sqrt;       // sqrt(bc2)
  float w1;             // 1 - b1
  float b2;
  float w2;             // 1 - b2
  float eps;
};

struct Table {
  Tensor t[kMaxTensors];
  int count;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Tensor& T) {
  m = __fmaf_rn(T.w1, __fsub_rn(g, m), m);
  v = __fmaf_rn(T.w2, __fmul_rn(g, g), __fmul_rn(v, T.b2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), T.bc2_sqrt), T.eps);
  p = __fmaf_rn(T.step_size, __fdiv_rn(m, d), p);
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& m,
                                        float4& v, const Tensor& T) {
  update(p.x, g.x, m.x, v.x, T);
  update(p.y, g.y, m.y, v.y, T);
  update(p.z, g.z, m.z, v.z, T);
  update(p.w, g.w, m.w, v.w, T);
}

// float4 units from `first` (this thread's first unit); unit n / 4, when n
// is not a multiple of 4, is the partial one, updated float by float
__device__ __forceinline__ void vector_units(const Tensor& T, int64_t first) {
  const int64_t full = T.n >> 2;
  float4* p4 = reinterpret_cast<float4*>(T.p);
  const float4* g4 = reinterpret_cast<const float4*>(T.g);
  float4* m4 = reinterpret_cast<float4*>(T.m);
  float4* v4 = reinterpret_cast<float4*>(T.v);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = first + (int64_t)(it * kUnroll + k) * kThreads;
      if (u < full) {
        p[k] = p4[u];
        g[k] = g4[u];
        m[k] = m4[u];
        v[k] = v4[u];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t u = first + (int64_t)(it * kUnroll + k) * kThreads;
      if (u < full) {
        update4(p[k], g[k], m[k], v[k], T);
        p4[u] = p[k];
        m4[u] = m[k];
        v4[u] = v[k];
      } else if (u == full) {
        for (int64_t e = 4 * full; e < T.n; ++e) {
          float pe = T.p[e], me = T.m[e], ve = T.v[e];
          update(pe, T.g[e], me, ve, T);
          T.p[e] = pe;
          T.m[e] = me;
          T.v[e] = ve;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table tab) {
  const int64_t b = blockIdx.x;
  int i = 0;
  while (i + 1 < tab.count && b >= tab.t[i + 1].first_block) ++i;
  const Tensor& T = tab.t[i];
  vector_units(T, (b - T.first_block) * kUnitsPerBlock + threadIdx.x);
}

}  // namespace

// One Adam update of `count` (<= 16) float32 tensors on one device, each
// contiguous: ptrs[4 i .. 4 i + 3] are tensor i's parameter, gradient,
// exp_avg and exp_avg_sq, sizes[i] its element count, and hyper[6 i ..
// 6 i + 5] its group's -lr / bc1, sqrt(bc2), 1 - b1, b2, 1 - b2 and eps.
// Every array is 16-byte aligned.
// One launch on `stream`, none when there is no element.
extern "C" int adam_launch(int count, const int64_t* ptrs,
                           const int64_t* sizes, const float* hyper,
                           cudaStream_t stream) {
  if (count < 0 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table tab = {};
  tab.count = count;
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    Tensor& T = tab.t[i];
    if (sizes[i] < 0) return (int)cudaErrorInvalidValue;
    T.p = reinterpret_cast<float*>(ptrs[4 * i]);
    T.g = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    T.m = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    T.v = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    T.n = sizes[i];
    const int64_t units = (T.n + 3) / 4;
    T.first_block = blocks;
    blocks += (units + kUnitsPerBlock - 1) / kUnitsPerBlock;
    T.step_size = hyper[6 * i];
    T.bc2_sqrt = hyper[6 * i + 1];
    T.w1 = hyper[6 * i + 2];
    T.b2 = hyper[6 * i + 3];
    T.w2 = hyper[6 * i + 4];
    T.eps = hyper[6 * i + 5];
  }
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  adam_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(tab);
  return (int)cudaGetLastError();
}
