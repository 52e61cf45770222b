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
// one block owns one (q tile, head, batch) and loops over the kv tiles
// itself, with m, l and acc in registers for the whole loop.
// q [B, Sq, H, hd] and k, v [B, Skv, K, hd] are read as they lie (row
// strides H·hd and K·hd): no transpose copy. The ragged tile edge is
// masked, so any Sq, Skv >= 1 work.
//
// Bound, at the serve path's shape (Llama-3.2-3B prefill: q [4, 2048, 24,
// 128], k and v [4, 2048, 8, 128], bf16, causal): the unmasked (q, k)
// pairs cost 4·hd flops each, 103.1 GFLOP, 0.104 ms at 989 TFLOP/s bf16;
// q, k, v and o once are 134 MB, 0.040 ms at 3.35 TB/s. Bound by
// operations, and only the tensor cores through wgmma reach that rate.
//
// Design of the bf16 path (the serve path's):
//   * one block of 384 threads per (q tile of 128 rows, head, batch):
//     two consumer warpgroups of 64 q rows each and a producer warpgroup,
//     which gives its registers to the consumers (setmaxnreg);
//   * the producer's first lane loads the Q tile once and then
//     every K and V tile by TMA (cp.async.bulk.tensor over 4-D tensor
//     maps of [B, S, heads, hd], 128- or 64-byte swizzle, rows past S
//     filled with zeros) into a ring of two stages; K and V each have a
//     "full" and an "empty" mbarrier per stage, so a K tile is released
//     as soon as its S is computed and the next tiles land while the
//     consumers multiply the current ones;
//   * S = Q·Kᵀ is one wgmma m64n{BK}k16 chain per warpgroup (Q and K
//     K-major from shared memory); S stays in registers, where the online
//     softmax reads it: row max and sum by shuffles among the four lanes
//     that share a row, exp2 with the scale folded in, fp32 m, l and O;
//     P is rounded to bf16 in registers (the accumulator layout is the
//     register-A layout) and O += P·V is a wgmma m64n{hd}k16 chain with
//     A from registers and V read MN-major through the transpose bit. No
//     S, P or O buffer in shared memory;
//   * each warpgroup runs S, the softmax and PV in order; the other
//     warpgroup's products fill the tensor cores meanwhile. (Issuing S of
//     tile j + 1 before P_j·V_j inside one warpgroup measured slower:
//     ptxas serialised the wgmma chains, or, with the last tile peeled,
//     spilled S, P and O; PERF.md.)
//   * masks are evaluated only on the tiles that need them (the causal
//     diagonal, the window's edge, the ragged end), and elsewhere the
//     scale is folded into the exp's argument (one FMA);
//   * the grid is (H, B, q tiles) with the q tile reversed on the slowest
//     axis, so the causal tiles that visit the most kv tiles start first
//     and no tail of long blocks is left at the end;
//   * kv tiles of 128 rows (64 at hd 256, to keep the O accumulator, S
//     and P in 240 registers); shared memory 40–193 KB, one block an SM.
// The fp32 path stays on the CUDA cores (fp32 FMAs): the tensor cores
// would round the operands to TF32, which the plain version does not.
// Both paths: kv tiles wholly above the causal diagonal, and below a
// window, are skipped where that is exact (kv_range); columns past Skv
// get probability exactly 0; shared memory above 48 KB is set with
// cudaFuncSetAttribute before the launch.
//
// C interface (ctypes): repro_flash_attention returns cudaGetLastError()
// after the launch (or the error of cudaFuncSetAttribute, or
// cudaErrorInvalidValue when a tensor map cannot be encoded); the caller
// raises on a non-zero code. The tensor maps are encoded on the host by
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block (fp32 path)
constexpr int BK = 64;          // kv rows per tile (fp32 path)
constexpr float NEG_INF = -1e30f;

// 2^x in one MUFU instruction (denormal results flush to 0; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether query row `row` attends to key column `col` (both from 0).
__device__ __forceinline__ bool visible(int col, int row, int Skv,
                                        int causal, int window) {
  bool ok = col < Skv;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// The kv tiles [lo, hi] (of TK rows) a q tile of TQ rows from q0 visits.
// Tiles wholly above the causal diagonal, and wholly below the window,
// are skipped only where every row of the q tile lies inside the keys, so
// every row keeps its own diagonal key: a skipped tile is then fully
// masked for every row, and the reference's arithmetic would have wiped
// it with a zero correction.
template <int TQ, int TK>
__device__ __forceinline__ void kv_range(int q0, int Sq, int Skv, int causal,
                                         int window, int* lo, int* hi) {
  const int q_last = min(q0 + TQ, Sq) - 1;
  *lo = 0;
  *hi = (Skv + TK - 1) / TK - 1;
  if (causal && q_last < Skv) {
    *hi = q_last / TK;
    if (window > 0) *lo = max(0, q0 - window + 1) / TK;
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
  kv_range<BQ, BK>(q0, Sq, Skv, causal, window, &lo, &hi);
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
// bf16 inputs: wgmma on the tensor cores, TMA copies, S and O in
// registers (see the design note at the top). Warps 0–7 are the two
// consumer warpgroups (rows 0–63 and 64–127 of the q tile), warps 8–11
// the producer warpgroup, whose first lane issues every copy. The
// producer hands its registers to the consumers (setmaxnreg: 24 and 240 a
// thread; the block starts with 168 each, and 128·(168 − 24) frees just
// the 256·(240 − 168) the consumers take).

constexpr int BF16_BQ = 128;                 // q rows per block
constexpr int BF16_THREADS = 3 * 128;       // two consumer warpgroups and
                                             // a producer warpgroup
constexpr int BF16_STAGES = 2;               // K/V ring depth

template <int HD>
struct Bf16Tile {
  static constexpr int BK = HD == 256 ? 64 : 128;   // kv rows per tile
  static constexpr int SW = HD >= 64 ? 128 : 64;    // bytes a block row
  static constexpr int E = SW / 2;                  // bf16 a block row
  static constexpr int NB = HD / E;                 // column blocks
  static constexpr uint32_t Q_BYTES = BF16_BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;  // one of K, V
  static constexpr uint32_t BAR_OFF = Q_BYTES + BF16_STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the base to the swizzle atom
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * BF16_STAGES);
};

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                            int H, int K, int causal, int window,
                            float scale_log2) {
  using T = Bf16Tile<HD>;
  constexpr int BK = T::BK, SW = T::SW, E = T::E, NB = T::NB;
  extern __shared__ unsigned char fa_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = hopper::smem_addr(base);       // [NB][BQ][E]
  const uint32_t sKV = sQ + T::Q_BYTES;              // stage: K, then V
  // mbarriers: Q, then per stage K full, V full, K empty, V empty; K and
  // V have their own, so a K tile is released as soon as S is computed
  const uint32_t q_bar = sQ + T::BAR_OFF;
  auto bar = [&](int kind, int st) {
    return q_bar + 8 * (1 + kind * BF16_STAGES + st);
  };
  enum { K_FULL = 0, V_FULL = 1, K_EMPTY = 2, V_EMPTY = 3 };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BF16_BQ;   // heaviest first
  const int kh = h * K / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int lo, hi;
  kv_range<BF16_BQ, BK>(q0, Sq, Skv, causal, window, &lo, &hi);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int s = 0; s < BF16_STAGES; ++s) {
      hopper::mbar_init(bar(K_FULL, s), 1);
      hopper::mbar_init(bar(V_FULL, s), 1);
      hopper::mbar_init(bar(K_EMPTY, s), 2 * 128);
      hopper::mbar_init(bar(V_EMPTY, s), 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------- producer
    hopper::setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      hopper::mbar_arrive_expect_tx(q_bar, T::Q_BYTES);
      for (int c = 0; c < NB; ++c) {
        hopper::tma_load_4d(sQ + c * BF16_BQ * SW, &tq, q_bar, c * E, h, q0,
                            b);
      }
      for (int j = lo, it = 0; j <= hi; ++j, ++it) {
        const int s = it % BF16_STAGES;
        const uint32_t phase = (it / BF16_STAGES - 1) & 1;
        const uint32_t kb = sKV + s * 2 * T::KV_BYTES;
        const uint32_t vb = kb + T::KV_BYTES;
        if (it >= BF16_STAGES) hopper::mbar_wait(bar(K_EMPTY, s), phase);
        hopper::mbar_arrive_expect_tx(bar(K_FULL, s), T::KV_BYTES);
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_4d(kb + c * BK * SW, &tk, bar(K_FULL, s), c * E,
                              kh, j * BK, b);
        }
        if (it >= BF16_STAGES) hopper::mbar_wait(bar(V_EMPTY, s), phase);
        hopper::mbar_arrive_expect_tx(bar(V_FULL, s), T::KV_BYTES);
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_4d(vb + c * BK * SW, &tv, bar(V_FULL, s), c * E,
                              kh, j * BK, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  hopper::setmaxnreg_inc<240>();
  const int wg = warp >> 2;                  // this warpgroup's 64 rows
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;   // and row0 + 8
  const int rmin = q0 + wg * 64, rmax = rmin + 63;
  const uint32_t q_wg = sQ + wg * 64 * SW;

  float o[HD / 2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums

  // S = Q·K_jᵀ for the kv tile in stage `st`, both K-major in shared
  // memory; issued and committed, not waited for
  auto issue_qk = [&](int st) {
    const uint32_t kb = sKV + st * 2 * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 / E;                   // column block
      const uint32_t off = (kk * 16 % E) * 2;      // bytes into its row
      hopper::wgmma_ss<BK>(
          s,
          hopper::gmma_desc<SW>(q_wg + c * BF16_BQ * SW + off, 16, 8 * SW),
          hopper::gmma_desc<SW>(kb + c * BK * SW + off, 16, 8 * SW), kk > 0);
    }
    hopper::wgmma_commit();
  };

  // The online softmax of kv tile j on S where the MMA left it:
  // s[4jb + 2·half + e] is row row0 + 8·half, column k0 + 8jb + 2t + e.
  // Leaves the probabilities in s (fp32), updates m and l, and leaves in
  // corr the factor O must be rescaled by before P_j·V_j is added.
  float corr[2];
  auto softmax = [&](int j) {
    const int k0 = j * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > rmin) ||
                      (window > 0 && k0 <= rmax - window);
    // max and sum in four partial chains per row, so the adds and maxes
    // do not wait on each other: q = (i >> 2) & 3
    float mq[2][4], sq[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mq[0][q] = mq[1][q] = NEG_INF;
      sq[0][q] = sq[1][q] = 0.f;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i >> 1) & 1;
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = row0 + 8 * half;
        float v = s[i] * scale_log2;
        if (col >= Skv) {
          v = -INFINITY;          // no key: probability exactly 0
        } else if (!visible(col, row, Skv, causal, window)) {
          v = NEG_INF;
        }
        s[i] = v;
        mq[half][(i >> 2) & 3] = fmaxf(mq[half][(i >> 2) & 3], v);
      }
    } else {
      // the scale is folded into the exp's argument below; it is positive,
      // so the row max of the raw scores is the max of the scaled ones
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i >> 1) & 1;
        mq[half][(i >> 2) & 3] = fmaxf(mq[half][(i >> 2) & 3], s[i]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = fmaxf(fmaxf(mq[hf][0], mq[hf][1]),
                       fmaxf(mq[hf][2], mq[hf][3]));
      if (!edge) mx *= scale_log2;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      corr[hf] = exp2_approx(m[hf] - m_new);
      m[hf] = m_new;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i >> 1) & 1;
        s[i] = exp2_approx(s[i] - m[half]);
        sq[half][(i >> 2) & 3] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i >> 1) & 1;
        s[i] = exp2_approx(fmaf(s[i], scale_log2, -m[half]));
        sq[half][(i >> 2) & 3] += s[i];
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] = l[hf] * corr[hf] +
              ((sq[hf][0] + sq[hf][1]) + (sq[hf][2] + sq[hf][3]));
    }
  };

  // Per kv tile: S = Q·K_jᵀ, the softmax, O += P_j·V_j, each warpgroup in
  // order; the two warpgroups of the block interleave on the SM, so one's
  // softmax runs while the other's products hold the tensor cores.
  hopper::mbar_wait(q_bar, 0);
  for (int j = lo, it = 0; j <= hi; ++j, ++it) {
    const int st = it % BF16_STAGES;
    hopper::mbar_wait(bar(K_FULL, st), (it / BF16_STAGES) & 1);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    issue_qk(st);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::mbar_arrive(bar(K_EMPTY, st));
    softmax(j);
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        __nv_bfloat162 p2 =
            __floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<uint32_t*>(&p2);
      }
    }
    hopper::fence_regs(o);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    hopper::mbar_wait(bar(V_FULL, st), (it / BF16_STAGES) & 1);
    hopper::wgmma_fence();
    const uint32_t vb = sKV + st * 2 * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hopper::wgmma_rs<HD>(
          o, pa[kk],
          hopper::gmma_desc<SW>(vb + kk * 16 * SW, BK * SW, 8 * SW));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(bar(V_EMPTY, st));
  }

  // O / l, rounded to bf16, rows < Sq written
  float den[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float v = l[hf];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    den[hf] = fmaxf(v, 1e-30f);
  }
  const int64_t q_row = (int64_t)H * HD;
  __nv_bfloat16* ob = out + (int64_t)b * Sq * q_row + (int64_t)h * HD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 8 * hf;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + (int64_t)row * q_row + 2 * t;
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb) =
          __floats2bfloat162_rn(o[4 * jb + 2 * hf] / den[hf],
                                o[4 * jb + 2 * hf + 1] / den[hf]);
    }
  }
}

// ---------------------------------------------------------------- launch

// fp32 path: (q tiles, H, B)
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D bf16 tensor map over x [B, S, heads, hd] (hd innermost) whose box
// is one column block of `rows` rows of one head: E × 1 × rows × 1, with
// the swizzle of SW bytes; rows past S read as zeros.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* x, int B,
                int S, int heads, int hd, int E, int rows, int SW) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)E, 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int K, int causal, int window,
                cudaStream_t stream) {
  using T = Bf16Tile<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(enc, &tq, q, B, Sq, H, HD, T::E, BF16_BQ, T::SW) ||
      !tensor_map(enc, &tk, k, B, Skv, K, HD, T::E, T::BK, T::SW) ||
      !tensor_map(enc, &tv, v, B, Skv, K, HD, T::E, T::BK, T::SW)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B,
                  (unsigned)((Sq + BF16_BQ - 1) / BF16_BQ));
  flash_attention_bf16_kernel<HD><<<grid, BF16_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, K, causal,
      window, 1.4426950408889634f / sqrtf((float)HD));
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
// for bfloat16, 16-byte aligned, as TMA needs); hd in {32, 64, 128, 256};
// H % K == 0; window 0 = no window.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int K, int hd,
                                     int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || K <= 0 || H % K != 0 ||
      B > 65535 || H > 65535 || (Sq + 127) / 128 > 65535 || window < 0) {
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
