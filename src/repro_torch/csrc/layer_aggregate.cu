// Layer-aligned client/server aggregation (paper Eq. 8) for NVIDIA Hopper
// (sm_90a).
//
//     out[l, f] = (sum_n ww[n, l] * c[n, l, f] + lam * s[l, f])
//                 / (sum_n ww[n, l] + lam)
//
// ww already folds the presence mask (ww[n, l] = w_n * (l < d_n)).
//
// The numerator mode (repro_aggregate_numerator) stops before the division
// and writes num[l, f] = sum_n ww[n, l] * c[n, l, f] in fp32: on a fleet
// mesh each rank sums its own clients' rows, the ranks all-reduce the
// numerators, and the division runs once after. It reads c once and writes
// 4·L·F bytes, the same bound as the full mode less the read of s.
//
// Replaces the TPU kernel src/repro/kernels/layer_aggregate/kernel.py::
// aggregate_3d, which swaps c to [L, N, F], pads F to 512-wide blocks and
// reduces one layer's [N, 512] client slab per grid step in VMEM. Here c
// is read in place as [N, L, F]: no swapaxes copy, no padding.
//
// Bound: memory. The kernel reads c once (4·N·L·F bytes in fp32) and s
// once and writes out (8·L·F bytes), for 2·N + 3 flops per output — far
// below the fp32 ridge. At N = 8 and a [12, 768, 3072] leaf that is
// ~1.13 GB, ~0.34 ms at 3.35 TB/s.
//
// Design:
//   * block (x, l) covers 256 consecutive f of layer l; each thread owns
//     one (l, f) and sums over n = 0..N-1 in order, in fp32 — deterministic,
//     no atomics, no cross-block reduction;
//   * the block stages the weight column ww[:, l] in shared memory and one
//     thread sums it in order into the denominator, once per block;
//   * neighbouring threads read neighbouring f, so every load of c[n, l, :]
//     and s[l, :] coalesces.
//
// C interface (ctypes): repro_aggregate returns cudaGetLastError() after
// the launch; the caller raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kNormalise: out (T) = (num + lam·s) / (den + lam); otherwise out (float)
// = num, and s, lam and the denominator are unused.
template <typename T, bool kNormalise, typename Out>
__global__ void aggregate_kernel(const T* __restrict__ c,
                                 const float* __restrict__ ww,
                                 const T* __restrict__ s,
                                 Out* __restrict__ out, float lam, int N,
                                 int L, int64_t F) {
  extern __shared__ float ww_col[];  // ww[:, l], N floats
  __shared__ float den;
  const int l = blockIdx.y;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    ww_col[n] = ww[(int64_t)n * L + l];
  }
  __syncthreads();
  if (kNormalise && threadIdx.x == 0) {
    float acc = 0.0f;
    for (int n = 0; n < N; ++n) acc += ww_col[n];
    den = acc;
  }
  __syncthreads();
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int64_t lf = (int64_t)l * F + f;
  const int64_t n_stride = (int64_t)L * F;
  float acc = 0.0f;
  for (int n = 0; n < N; ++n) {
    acc = fmaf(ww_col[n], to_f32(c[(int64_t)n * n_stride + lf]), acc);
  }
  if (kNormalise) {
    out[lf] = from_f32<Out>((acc + lam * to_f32(s[lf])) / (den + lam));
  } else {
    out[lf] = from_f32<Out>(acc);
  }
}

template <typename T, bool kNormalise, typename Out>
void launch(const void* c, const void* ww, const void* s, void* out,
            float lam, int N, int L, int64_t F, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((F + threads - 1) / threads), (unsigned)L);
  const size_t smem = sizeof(float) * (size_t)N;
  aggregate_kernel<T, kNormalise, Out><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(c), static_cast<const float*>(ww),
      static_cast<const T*>(s), static_cast<Out*>(out), lam, N, L, F);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (c, s and out share it; ww is float32).
extern "C" int repro_aggregate(int dtype, const void* c, const void* ww,
                               const void* s, void* out, float lam, int N,
                               int L, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, true, float>(c, ww, s, out, lam, N, L, F, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, true, __nv_bfloat16>(c, ww, s, out, lam, N, L, F,
                                               st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The numerator mode: out is float32 [L, F] whatever c's dtype.
extern "C" int repro_aggregate_numerator(int dtype, const void* c,
                                         const void* ww, void* out, int N,
                                         int L, int64_t F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, false, float>(c, ww, nullptr, out, 0.0f, N, L, F, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, false, float>(c, ww, nullptr, out, 0.0f, N, L, F,
                                        st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
