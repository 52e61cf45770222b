// TPGF Phase-3 gradient fusion (paper Eq. 4) for NVIDIA Hopper (sm_90a).
//
//     out = w * (a * cs) + (1 - w) * b        fp32 math, stored in a's type
//
// Replaces the TPU kernel src/repro/kernels/tpgf_fusion/kernel.py::fuse_2d,
// which pads every gradient leaf to [M, 128] tiles and walks 256-row blocks
// with the two scalars in SMEM. Here the leaf is read as it lies: one
// contiguous elementwise pass, no padding, the ragged tail masked in the
// kernel.
//
// Bound: memory. Per element it reads a and b and writes out — 12 bytes in
// fp32, 6 in bf16 — for 4 flops, far below the card's ~20 flops/byte
// fp32 ridge. At 3.35 TB/s a [12, 768, 3072] fp32 leaf (340 MB moved)
// cannot take less than ~0.10 ms.
//
// Design:
//   * a grid-stride loop over 16-byte vectors (4 fp32 or 8 bf16 values a
//     thread per trip) when all three pointers are 16-byte aligned, then a
//     scalar loop over the tail (or the whole leaf when unaligned);
//   * w is read through a device pointer: the TPGF weight is computed on
//     the device from the two losses, and passing it as a host float would
//     cost one host sync per client per step;
//   * the two products and the sum are rounded one by one (__fmul_rn,
//     __fadd_rn: never contracted into an FMA), so the result equals the
//     plain PyTorch formula bit for bit.
//
// C interface (ctypes): repro_fuse returns cudaGetLastError() after the
// launch; the caller raises on a non-zero code.

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

__device__ __forceinline__ float fuse1(float a, float b, float w, float wb,
                                       float cs) {
  return __fadd_rn(__fmul_rn(w, __fmul_rn(a, cs)), __fmul_rn(wb, b));
}

template <typename T>
__global__ void fuse_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out,
                            const float* __restrict__ w_ptr, float cs,
                            int64_t n, int vectorized) {
  constexpr int V = 16 / sizeof(T);
  const float w = __ldg(w_ptr);
  const float wb = __fsub_rn(1.0f, w);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vectorized ? n / V : 0;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const uint4 ra = __ldg(reinterpret_cast<const uint4*>(a) + i);
    const uint4 rb = __ldg(reinterpret_cast<const uint4*>(b) + i);
    const T* ea = reinterpret_cast<const T*>(&ra);
    const T* eb = reinterpret_cast<const T*>(&rb);
    uint4 ro;
    T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      eo[k] = from_f32<T>(fuse1(to_f32(ea[k]), to_f32(eb[k]), w, wb, cs));
    }
    reinterpret_cast<uint4*>(out)[i] = ro;
  }
  for (int64_t i = n_vec * V + tid; i < n; i += stride) {
    out[i] = from_f32<T>(fuse1(to_f32(a[i]), to_f32(b[i]), w, wb, cs));
  }
}

template <typename T>
void launch(const void* a, const void* b, void* out, const void* w, float cs,
            int64_t n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  const bool vectorized =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t work = vectorized ? (n + V - 1) / V : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 waves
  if (blocks < 1) blocks = 1;
  fuse_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<const float*>(w), cs, n,
      vectorized ? 1 : 0);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it; w is float32).
extern "C" int repro_fuse(int dtype, const void* a, const void* b, void* out,
                          const void* w, float cs, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, out, w, cs, n, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, out, w, cs, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
