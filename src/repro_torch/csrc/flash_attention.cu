// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a).
//
//     out[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] · k[b, j, kh, :] / √hd)
//                       · v[b, j, kh, :],      kh = h·K / H,
//
// over the keys j with j <= i (causal) and j > i − window (window > 0),
// rows and columns both counted from 0. Online softmax with an fp32
// running max, sum and accumulator; masked scores are −1e30 (never −inf),
// the denominator is clamped at 1e-30, the output is in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_bhsd, which runs a (B, H, q block, kv block) grid with
// the kv axis innermost and carries m, l and acc in VMEM scratch across
// the sequential kv steps, on [B, H, S, hd] operands its wrapper
// transposes to. Hopper blocks run in parallel and in no order, so here
// one block owns one (q tile of 64 rows, head, batch) and loops over the
// kv tiles itself, with m and l in registers and acc in registers (fp32)
// or shared memory (bf16) for the whole loop.
// q [B, Sq, H, hd] and k, v [B, Skv, K, hd] are read as they lie (row
// strides H·hd and K·hd): no transpose copy. The ragged tile edge is
// masked, so any Sq, Skv >= 1 work.
//
// Bound, at the serve path's shape (Llama-3.2-3B prefill: q [4, 2048, 24,
// 128], k and v [4, 2048, 8, 128], bf16, causal): the unmasked (q, k)
// pairs cost 4·hd flops each, 103.1 GFLOP, 0.104 ms at 989 TFLOP/s bf16;
// q, k, v and o once are 134 MB, 0.040 ms at 3.35 TB/s. Bound by
// operations, and only the tensor cores (wgmma) reach that rate.
//
// Design (simple first kernels; wgmma, TMA and a warp-specialised
// pipeline are for later work):
//   * bf16 (the serve path): S = QKᵀ and O += PV on the tensor cores
//     through nvcuda::wmma 16×16×16 bf16 tiles with fp32 accumulation;
//     the online softmax in fp32 between them; the fp32 accumulator in
//     shared memory, rescaled by the lanes that own its rows (113 KB of
//     dynamic shared memory at hd = 128, 195 KB at hd = 256);
//   * fp32: fp32 FMAs on CUDA cores, since the tensor cores would round
//     the operands to TF32, which the plain version does not;
//   * both: one block per (q tile, head, batch) looping over kv tiles;
//     kv tiles wholly above the causal diagonal, and below a window, are
//     skipped where that is exact (kv_range); columns past Skv get score
//     −1e30 and probability exactly 0; shared memory above 48 KB is set
//     with cudaFuncSetAttribute before the launch.
//
// C interface (ctypes): repro_flash_attention returns cudaGetLastError()
// after the launch (or the error of cudaFuncSetAttribute); the caller
// raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr float NEG_INF = -1e30f;

// Whether query row `row` attends to key column `col` (both from 0).
__device__ __forceinline__ bool visible(int col, int row, int Skv,
                                        int causal, int window) {
  bool ok = col < Skv;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// The kv tiles [lo, hi] a q tile visits. Tiles wholly above the causal
// diagonal, and wholly below the window, are skipped only where every
// row of the q tile lies inside the keys, so every row keeps its own
// diagonal key: a skipped tile is then fully masked for every row, and
// the reference's arithmetic would have wiped it with a zero correction.
__device__ __forceinline__ void kv_range(int q0, int Sq, int Skv, int causal,
                                         int window, int* lo, int* hi) {
  const int q_last = min(q0 + BQ, Sq) - 1;
  *lo = 0;
  *hi = (Skv + BK - 1) / BK - 1;
  if (causal && q_last < Skv) {
    *hi = q_last / BK;
    if (window > 0) *lo = max(0, q0 - window + 1) / BK;
  }
}

// ----------------------------------------------------------------- fp32
// fp32 inputs: fp32 FMAs on CUDA cores (the tensor cores would round to
// TF32, which the plain version does not). 256 threads; thread (ty, tx)
// owns score rows ty·4 .. ty·4+3 and columns tx + 16·j, and the same rows
// of the output, so a row's running max and sum reduce by shuffles within
// 16 lanes and the accumulator is rescaled in registers. Q and K rows are
// padded by one float, so the column reads of S = QKᵀ hit distinct banks.

constexpr int F32_THREADS = 256;

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
          (size_t)BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Skv, int H,
                           int K, int causal, int window, float scale) {
  constexpr int QK_LD = HD + 1;
  constexpr int P_LD = BK + 1;
  constexpr int CPT = HD / 16;    // output columns per thread
  extern __shared__ float f32_smem[];
  float* Qs = f32_smem;                // [BQ][QK_LD]
  float* Ks = Qs + BQ * QK_LD;         // [BK][QK_LD]
  float* Vs = Ks + BK * QK_LD;         // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][P_LD]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h * K / H;
  const int64_t q_row = (int64_t)H * HD;
  const int64_t kv_row = (int64_t)K * HD;
  const float* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * HD;
  const float* kb = k + (int64_t)b * Skv * kv_row + (int64_t)kh * HD;
  const float* vb = v + (int64_t)b * Skv * kv_row + (int64_t)kh * HD;
  float* ob = out + (int64_t)b * Sq * q_row + (int64_t)h * HD;

  for (int i = tid; i < BQ * HD; i += F32_THREADS) {
    const int r = i / HD, d = i % HD;
    const int row = q0 + r;
    Qs[r * QK_LD + d] = row < Sq ? qb[(int64_t)row * q_row + d] : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, Sq, Skv, causal, window, &lo, &hi);
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * HD; i += F32_THREADS) {
      const int r = i / HD, d = i % HD;
      const int col = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (col < Skv) {
        kv = kb[(int64_t)col * kv_row + d];
        vv = vb[(int64_t)col * kv_row + d];
      }
      Ks[r * QK_LD + d] = kv;
      Vs[r * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QK_LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * QK_LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        s[i][c] = visible(col, row, Skv, causal, window) ? s[i][c] * scale
                                                         : NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        const float p = col < Skv ? expf(s[i][c] - m_new) : 0.f;
        Ps[(ty * 4 + i) * P_LD + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * P_LD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = Vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      ob[(int64_t)row * q_row + tx + 16 * cc] = acc[i][cc] / den;
    }
  }
}

// ----------------------------------------------------------------- bf16
// bf16 inputs: S = QKᵀ and O += PV on the tensor cores (nvcuda::wmma
// 16×16×16 bf16 tiles, fp32 accumulation). 4 warps; warp w owns q rows
// 16w .. 16w+15 of the tile in S, P and O, so only the K and V tiles are
// shared and everything else needs a warp-level sync alone. Two lanes
// keep one row's running max and sum (32 columns each). The fp32
// accumulator O lives in shared memory, where the lanes rescale it by the
// row's correction before the next PV product is added to it. P is
// rounded to bf16 for the product, as the plain version rounds its
// probabilities to v's dtype; the sum l stays in fp32. Tiles move as
// 16-byte vectors (the wrapper checks the pointers' alignment).

constexpr int BF16_THREADS = 128;

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return 2 * (size_t)(BQ + 2 * BK) * (HD + 8)     // Q, K, V
         + 4 * (size_t)BQ * (BK + 4)               // S
         + 2 * (size_t)BQ * (BK + 8)               // P
         + 4 * (size_t)BQ * (HD + 4)               // O
         + 4 * (size_t)BQ;                         // row sums
}

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                            int H, int K, int causal, int window,
                            float scale) {
  namespace wm = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  // leading dimensions: multiples of 8 (bf16) and 4 (fp32) elements, and
  // every 16-row / 16-column fragment start 32-byte aligned
  constexpr int X_LD = HD + 8;
  constexpr int S_LD = BK + 4;
  constexpr int P_LD = BK + 8;
  constexpr int O_LD = HD + 4;
  constexpr int CH = HD / 8;      // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char bf16_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bf16_smem);       // [BQ][X_LD]
  bf16* Ks = Qs + BQ * X_LD;                           // [BK][X_LD]
  bf16* Vs = Ks + BK * X_LD;                           // [BK][X_LD]
  float* Ss = reinterpret_cast<float*>(Vs + BK * X_LD);  // [BQ][S_LD]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * S_LD);  // [BQ][P_LD]
  float* Os = reinterpret_cast<float*>(Ps + BQ * P_LD);  // [BQ][O_LD]
  float* Ls = Os + BQ * O_LD;                          // [BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h * K / H;
  const int64_t q_row = (int64_t)H * HD;
  const int64_t kv_row = (int64_t)K * HD;
  const bf16* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * HD;
  const bf16* kb = k + (int64_t)b * Skv * kv_row + (int64_t)kh * HD;
  const bf16* vb = v + (int64_t)b * Skv * kv_row + (int64_t)kh * HD;
  bf16* ob = out + (int64_t)b * Sq * q_row + (int64_t)h * HD;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * CH; i += BF16_THREADS) {
    const int r = i / CH, c = i % CH;
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * X_LD + c * 8) =
        row < Sq ? *reinterpret_cast<const uint4*>(qb + (int64_t)row * q_row +
                                                   c * 8)
                 : zero;
  }
  for (int i = tid; i < BQ * HD; i += BF16_THREADS) {
    Os[(i / HD) * O_LD + i % HD] = 0.f;
  }

  const int my_row = warp * 16 + (lane >> 1);   // this lane's row, in-tile
  const int half = lane & 1;                    // its 32 of the 64 columns
  const int row_g = q0 + my_row;
  float m = NEG_INF, l = 0.f;

  int lo, hi;
  kv_range(q0, Sq, Skv, causal, window, &lo, &hi);
  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();              // every warp is done with the last K, V
    for (int i = tid; i < BK * CH; i += BF16_THREADS) {
      const int r = i / CH, c = i % CH;
      const int col = k0 + r;
      uint4 kv = zero, vv = zero;
      if (col < Skv) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)col * kv_row +
                                             c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)col * kv_row +
                                             c * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * X_LD + c * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * X_LD + c * 8) = vv;
    }
    __syncthreads();

    // S[16 rows of this warp][64] = Q Kᵀ
    wm::fragment<wm::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wm::fill_fragment(sacc[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::load_matrix_sync(a, Qs + warp * 16 * X_LD + kk * 16, X_LD);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kt;
        wm::load_matrix_sync(kt, Ks + n * 16 * X_LD + kk * 16, X_LD);
        wm::mma_sync(sacc[n], a, kt, sacc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wm::store_matrix_sync(Ss + warp * 16 * S_LD + n * 16, sacc[n], S_LD,
                            wm::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 columns of its row
    const float* srow = Ss + my_row * S_LD + half * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      sv[c] = visible(col, row_g, Skv, causal, window) ? srow[c] * scale
                                                       : NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    bf16* prow = Ps + my_row * P_LD + half * 32;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = k0 + half * 32 + c;
      const float p = col < Skv ? expf(sv[c] - m_new) : 0.f;
      prow[c] = __float2bfloat16_rn(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    float* orow = Os + my_row * O_LD + half * (HD / 2);
#pragma unroll 8
    for (int c = 0; c < HD / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O[16 rows of this warp][HD] += P V
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pa[BK / 16];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wm::load_matrix_sync(pa[kk], Ps + warp * 16 * P_LD + kk * 16, P_LD);
    }
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wm::fragment<wm::accumulator, 16, 16, 16, float> oacc;
      float* otile = Os + warp * 16 * O_LD + n * 16;
      wm::load_matrix_sync(oacc, otile, O_LD, wm::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vt;
        wm::load_matrix_sync(vt, Vs + kk * 16 * X_LD + n * 16, X_LD);
        wm::mma_sync(oacc, pa[kk], vt, oacc);
      }
      wm::store_matrix_sync(otile, oacc, O_LD, wm::mem_row_major);
    }
  }

  if (half == 0) Ls[my_row] = fmaxf(l, 1e-30f);
  __syncthreads();
  for (int i = tid; i < BQ * HD; i += BF16_THREADS) {
    const int r = i / HD, c = i % HD;
    const int row = q0 + r;
    if (row < Sq) {
      ob[(int64_t)row * q_row + c] = __float2bfloat16_rn(Os[r * O_LD + c] /
                                                         Ls[r]);
    }
  }
}

// ---------------------------------------------------------------- launch

dim3 grid_of(int B, int Sq, int H) {
  return dim3((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Skv, int H, int K, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_f32_kernel<HD><<<grid_of(B, Sq, H), F32_THREADS, smem,
                                   stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, K,
      causal, window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int K, int causal, int window,
                cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bf16_kernel<HD><<<grid_of(B, Sq, H), BF16_THREADS, smem,
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, K, causal, window,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           void* out, int B, int Sq, int Skv, int H, int K, int causal,
           int window, cudaStream_t st) {
  if (dtype == 0) {
    return launch_f32<HD>(q, k, v, out, B, Sq, Skv, H, K, causal, window, st);
  }
  if (dtype == 1) {
    return launch_bf16<HD>(q, k, v, out, B, Sq, Skv, H, K, causal, window,
                           st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q and out [B, Sq, H, hd], k and v [B, Skv, K, hd], all contiguous (and,
// for bfloat16, 16-byte aligned); hd in {32, 64, 128, 256}; H % K == 0;
// window 0 = no window.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int K, int hd,
                                     int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      B > 65535 || H > 65535 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        st);
    case 64:
      return launch<64>(dtype, q, k, v, out, B, Sq, Skv, H, K, causal, window,
                        st);
    case 128:
      return launch<128>(dtype, q, k, v, out, B, Sq, Skv, H, K, causal,
                         window, st);
    case 256:
      return launch<256>(dtype, q, k, v, out, B, Sq, Skv, H, K, causal,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
