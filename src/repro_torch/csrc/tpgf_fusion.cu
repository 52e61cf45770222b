// TPGF fusion kernels for NVIDIA Hopper (sm_90a): Eq. 4 gradient fusion
// (fuse), the cross-tier weighted sum (tier_sum) and the clip norm's sum
// of squares (sumsq). C interface (ctypes): each repro_* function returns
// cudaGetLastError() after its launches; the caller raises on a non-zero
// code.
//
// ---- fuse --------------------------------------------------------------
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
//   * w and cs are read through device pointers: the TPGF weight is
//     computed on the device from the two losses and the clip scale from
//     sumsq, and passing either as a host float would cost one host sync
//     per leaf;
//   * the two products and the sum are rounded one by one (__fmul_rn,
//     __fadd_rn: never contracted into an FMA), so the result equals the
//     plain PyTorch formula bit for bit.
//
// ---- tier_sum ----------------------------------------------------------
//
//     out = sum_t w[t] * x[t]      over T <= 8 same-shape fp32 leaves
//
// Replaces kernel.py::tier_sum_2d, which needs the tiers stacked into one
// padded [T, M, 128k] array (ops.py jnp.stack: one extra copy of every
// tier) and accumulates over an innermost grid axis. Here the T leaves are
// read where they lie: their pointers travel by value in a small struct.
//
// Bound: memory. (T + 1) * 4 bytes and 2T - 1 flops an element; at T = 2
// and a [7, 768, 3072] leaf, 198 MB, ~0.059 ms at 3.35 TB/s.
//
// Design: the same vector/tail walk as fuse; the weights are read through
// a device pointer (device scalars: tier masses from on-device losses);
// acc = w0 * x0, then acc = acc + w_t * x_t in tier order, each product
// and sum rounded on its own — the plain path's order, so the kernel
// equals it bit for bit.
//
// ---- sumsq -------------------------------------------------------------
//
//     total += sum_i x[i]^2        fp32, x fp32 or bf16
//
// Replaces kernel.py::sumsq_2d, whose sequential TPU grid carries one
// accumulator from step to step. Hopper blocks run in no order, so this is
// a deterministic two-level reduction with no float atomics: pass 1 runs a
// fixed grid (a function of n only) where each block reduces its
// grid-stride slice (per-thread serial sums, then warp shuffles, then
// shared memory, all in a fixed order) into partials[block]; pass 2 is one
// block that reduces the partials in the same fixed order and adds the
// leaf's total to *total. Called leaf by leaf, it sums the tree's leaf
// totals in leaf order on the device, as the reference adds them, and
// two calls on the same input give the same bits.
//
// Bound: memory. 4 bytes (fp32) and 2 flops an element; a [10, 768, 3072]
// fp32 leaf is 94 MB, ~0.028 ms at 3.35 TB/s.

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
                            const float* __restrict__ w_ptr,
                            const float* __restrict__ cs_ptr, int64_t n,
                            int vectorized) {
  constexpr int V = 16 / sizeof(T);
  const float w = __ldg(w_ptr);
  const float cs = __ldg(cs_ptr);
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
void launch_fuse(const void* a, const void* b, void* out, const void* w,
                 const void* cs, int64_t n, cudaStream_t stream) {
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
      static_cast<T*>(out), static_cast<const float*>(w),
      static_cast<const float*>(cs), n, vectorized ? 1 : 0);
}

// ------------------------------------------------------------- tier_sum

constexpr int kMaxTiers = 8;

struct TierPtrs {
  const float* x[kMaxTiers];
};

__global__ void tier_sum_kernel(TierPtrs p, int T,
                                const float* __restrict__ w_ptr,
                                float* __restrict__ out, int64_t n,
                                int vectorized) {
  float w[kMaxTiers];
#pragma unroll
  for (int t = 0; t < kMaxTiers; ++t) w[t] = t < T ? __ldg(w_ptr + t) : 0.f;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vectorized ? n / 4 : 0;
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 x = __ldg(reinterpret_cast<const float4*>(p.x[0]) + i);
    float4 acc = make_float4(__fmul_rn(w[0], x.x), __fmul_rn(w[0], x.y),
                             __fmul_rn(w[0], x.z), __fmul_rn(w[0], x.w));
#pragma unroll
    for (int t = 1; t < kMaxTiers; ++t) {  // constant indices: registers
      if (t >= T) break;
      x = __ldg(reinterpret_cast<const float4*>(p.x[t]) + i);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w[t], x.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w[t], x.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w[t], x.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w[t], x.w));
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
  for (int64_t i = n_vec * 4 + tid; i < n; i += stride) {
    float acc = __fmul_rn(w[0], __ldg(p.x[0] + i));
#pragma unroll
    for (int t = 1; t < kMaxTiers; ++t) {
      if (t >= T) break;
      acc = __fadd_rn(acc, __fmul_rn(w[t], __ldg(p.x[t] + i)));
    }
    out[i] = acc;
  }
}

// ---------------------------------------------------------------- sumsq

constexpr int kSumsqThreads = 256;

// Sum of v over the block in a fixed order: warp shuffles, then warp 0
// over the per-warp sums. The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kSumsqThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kSumsqThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
  }
  return v;
}

__device__ __forceinline__ float sq_acc(float acc, float v) {
  return __fadd_rn(acc, __fmul_rn(v, v));
}

template <typename T>
__global__ void sumsq_partial_kernel(const T* __restrict__ x, int64_t n,
                                     int vectorized,
                                     float* __restrict__ partials) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n_vec = vectorized ? n / V : 0;
  float acc = 0.f;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < V; ++k) acc = sq_acc(acc, to_f32(e[k]));
  }
  for (int64_t i = n_vec * V + tid; i < n; i += stride) {
    acc = sq_acc(acc, to_f32(x[i]));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void sumsq_final_kernel(const float* __restrict__ partials,
                                   int n_partials, float* __restrict__ total) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x) {
    acc = __fadd_rn(acc, partials[i]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) total[0] = __fadd_rn(total[0], acc);
}

template <typename T>
void launch_sumsq(const void* x, int64_t n, void* partials, int max_blocks,
                  void* total, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vectorized = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  const int64_t work = vectorized ? (n + V - 1) / V : n;
  int64_t blocks = (work + kSumsqThreads - 1) / kSumsqThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  sumsq_partial_kernel<T><<<(unsigned)blocks, kSumsqThreads, 0, stream>>>(
      static_cast<const T*>(x), n, vectorized ? 1 : 0,
      static_cast<float*>(partials));
  sumsq_final_kernel<<<1, kSumsqThreads, 0, stream>>>(
      static_cast<const float*>(partials), (int)blocks,
      static_cast<float*>(total));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it; w and cs are
// one-element float32 device buffers).
extern "C" int repro_fuse(int dtype, const void* a, const void* b, void* out,
                          const void* w, const void* cs, int64_t n,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fuse<float>(a, b, out, w, cs, n, s);
  } else if (dtype == 1) {
    launch_fuse<__nv_bfloat16>(a, b, out, w, cs, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xs: a host array of T device pointers to n float32 values each; w: T
// float32 device values; out: n float32 device values.
extern "C" int repro_tier_sum(int T, const void* const* xs, const void* w,
                              void* out, int64_t n, void* stream) {
  if (T < 1 || T > kMaxTiers) return (int)cudaErrorInvalidValue;
  TierPtrs p = {};
  uintptr_t bits = reinterpret_cast<uintptr_t>(out);
  for (int t = 0; t < T; ++t) {
    p.x[t] = static_cast<const float*>(xs[t]);
    bits |= reinterpret_cast<uintptr_t>(xs[t]);
  }
  const bool vectorized = bits % 16 == 0;
  const int threads = 256;
  const int64_t work = vectorized ? (n + 3) / 4 : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 waves
  if (blocks < 1) blocks = 1;
  tier_sum_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, T, static_cast<const float*>(w), static_cast<float*>(out), n,
      vectorized ? 1 : 0);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. partials: max_blocks float32 device
// scratch values; total: one float32 device value, added to in place.
extern "C" int repro_sumsq(int dtype, const void* x, int64_t n,
                           void* partials, int max_blocks, void* total,
                           void* stream) {
  if (max_blocks < 1 || max_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_sumsq<float>(x, n, partials, max_blocks, total, s);
  } else if (dtype == 1) {
    launch_sumsq<__nv_bfloat16>(x, n, partials, max_blocks, total, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
