// Mamba-2 SSD (state-space duality) chunked scan for NVIDIA Hopper
// (sm_90a), fp32.
//
// For each (batch b, head h), over the sequence in chunks of kChunk rows,
// with the state H [hd, st] carried from chunk to chunk (H = 0 at start):
//
//     s   = cumsum(dt·A)                                   [cl]
//     W   = tril(C Bᵀ ∘ exp(sᵢ − sⱼ)) · diag(dt)          [cl, cl]
//     y   = W x + exp(s)·(C Hᵀ) + D·x                      [cl, hd]
//     H  ← exp(s_last)·H + Σⱼ dtⱼ·exp(s_last − sⱼ)·xⱼ ⊗ Bⱼ
//
// (u = x·dt of the reference is folded into W and into the state
// update's coefficient). Returns y [Bt, S, nh, hd] and the final H
// [Bt, nh, hd, st]. D is optional (null means 0).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan,
// a (B, nh, n_chunks) grid with the chunk axis innermost: TPU grids run in
// order, so it carries H in VMEM scratch from one grid step to the next,
// on [B, nh, S, hd] operands its wrapper transposes to. Hopper blocks run
// in parallel and in no order, so here one block owns one (head, batch)
// and loops over the chunks itself, with H in registers for the whole
// loop. x [Bt, S, nh, hd] and dt [Bt, S, nh] are read as they lie (row
// strides nh·hd and nh): no transpose copy. B and C [Bt, S, st] are
// shared by every head (one group).
//
// Bound, at the Mamba2-2.7B serve shape (Bt 4, S 2048, nh 80, hd 64,
// st 128), as chip_smoke.py counts it: the two state contractions (C·Hᵀ
// and the state update, 2·hd·st each per row and head, 21.5 GFLOP) plus
// the chunked form's own terms at a chunk of 32 (the causal half of W·u
// and C·Bᵀ once per (batch, chunk)), 22.9 GFLOP, 0.34 ms at 67 TFLOP/s
// fp32; x and y once each, B, C, dt and H, 357 MB, 0.11 ms at 3.35 TB/s.
// Bound by operations.
//
// Design:
//   * a pre-pass (ssd_cb_kernel), once per (batch, chunk) and shared by
//     every head's block through L2: C·Bᵀ in fp32 FMAs, and Bᵀ split into
//     TF32 high parts and residuals, laid out as wgmma's K-major operand
//     (a workspace of kChunk² + 2·kChunk·max(st, 8) floats a chunk, 17 MB
//     at the Mamba2 shape);
//   * the scan: one block of one warpgroup (4 warps, hd padded to 64 rows)
//     per (head, batch), warp w owning rows 16w .. 16w+15 of H: 320 blocks
//     at the Mamba2 shape and 200 at Hymba's, 3 blocks an SM (31 KB of
//     shared memory a stage, <= 168 registers a thread), so every block is
//     resident in one wave from start to end;
//   * H never leaves registers: it is the accumulator of the state update
//     (a thread holds H[g][2t, 2t+1] of each 8-column block, as wgmma's
//     and mma.sync's accumulators lay it out) and, with the state index
//     permuted inside each block of 8 (logical t, t+4 ↔ physical 2t,
//     2t+1), the A operand of C·Hᵀ as the transposed product Yᵀ = H·Cᵀ;
//   * every product runs on the tensor cores at fp32-grade accuracy as
//     3xTF32: each fp32 operand is split into a TF32 high part (cvt.rna)
//     and its residual, and a_lo·b_hi + a_hi·b_lo + a_hi·b_hi are
//     accumulated in fp32 (plain TF32 would miss the 1e-4 gate). The state
//     update (coef·x)ᵀ·B, M = 64, is one wgmma chain (m64n{st}k8, A from
//     registers, B the pre-split Bᵀ) that runs under the rest of the
//     chunk; H·Cᵀ and xᵀ·Wᵀ are mma.sync m16n8k8 tiles per warp (their A
//     operand, H, would not fit the registers a wgmma chain over st keeps
//     in flight, and N is the chunk's 16 rows);
//   * a chunk of 16 rows; the next chunk's x, C, C·Bᵀ, Bᵀ and dt are
//     copied by cp.async into the other half of a double buffer while the
//     current one is computed: one block-wide barrier a chunk. The cumsum,
//     exp(s) and the state coefficients are computed by every warp in its
//     own lanes (shuffles), so no other barrier is needed;
//   * exp(sᵢ − sⱼ) is evaluated only for j <= i, where sᵢ − sⱼ <= 0 (A < 0,
//     dt >= 0), and always from the difference, never as exp(sᵢ)·exp(−sⱼ):
//     the upper half would overflow to inf, and inf·0 is NaN;
//   * rows at or past S are copied as zeros (cp.async's zero fill), so a
//     ragged last chunk adds nothing (u = 0 there), its s stays at the last
//     valid row's, and its rows are not written: any S >= 1 works. hd < 64
//     and st 4 are padded with zero rows and columns to 64 and 8.
//
// Supported (hd, st): (8, 4), (32, 8), (32, 16), (32, 128), (64, 16),
// (64, 32), (64, 128) — the shapes of the tests and of the ssm and hybrid
// configs, reduced and full; anything else returns cudaErrorInvalidValue.
//
// C interface (ctypes): repro_ssd_scan launches the pre-pass and the scan
// on one stream and returns cudaGetLastError() (or the error of
// cudaFuncSetAttribute); the caller raises on a non-zero code. It takes a
// workspace of Bt·ceil(S / 16)·(256 + 32·max(st, 8)) floats, which the
// caller allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 16;   // rows per chunk

// ------------------------------------------------------------ 3xTF32
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi in TF32; lo is passed raw (the tensor core reads
// its top 19 bits, an error of 2^-11 of a residual already 2^-11 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// (not volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b at fp32-grade accuracy: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// --------------------------------------------------------------- C·Bᵀ
// Per (chunk c, batch b), a record of the workspace: cb[i, j] = Σ_n
// C[b, c·kChunk + i, n] · B[b, c·kChunk + j, n] (kChunk² floats), then Bᵀ's
// TF32 high parts and residuals; rows at or past S read as zeros. One
// block of kChunk² threads, one C·Bᵀ output each, in fp32 FMAs.
template <int ST>
__global__ void __launch_bounds__(kChunk * kChunk)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int S) {
  constexpr int STP = ST < 8 ? 8 : ST;
  constexpr int REC = kChunk * kChunk + 2 * STP * kChunk;
  __shared__ float bs[kChunk][ST + 1];
  __shared__ float cs[kChunk][ST + 1];
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * kChunk;
  const int n = min(kChunk, S - t0);
  const int64_t base = ((int64_t)b * S + t0) * ST;
  for (int e = threadIdx.x; e < kChunk * ST; e += kChunk * kChunk) {
    const int r = e / ST, k = e % ST;
    bs[r][k] = r < n ? Bm[base + e] : 0.f;
    cs[r][k] = r < n ? Cm[base + e] : 0.f;
  }
  __syncthreads();
  const int i = threadIdx.x / kChunk, j = threadIdx.x % kChunk;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < ST; ++k) acc = fmaf(cs[i][k], bs[j][k], acc);
  float* rec = cb + ((int64_t)b * gridDim.x + c) * REC;
  rec[threadIdx.x] = acc;
  // Bᵀ [STP][kChunk] split into TF32 high parts and residuals, each in
  // wgmma's K-major no-swizzle layout: 8-row × 4-column core matrices of
  // 128 bytes, the kChunk / 4 of one 8-row group side by side
  float* hi = rec + kChunk * kChunk;
  float* lo = hi + STP * kChunk;
  for (int e = threadIdx.x; e < STP * kChunk; e += kChunk * kChunk) {
    const int nn = e / kChunk, j = e % kChunk;
    const float raw = nn < ST ? bs[j][nn] : 0.f;
    const int at = (nn / 8) * (8 * kChunk) + (j / 4) * 32 + (nn % 8) * 4 +
                   j % 4;
    const float h = __uint_as_float(tf32_hi(raw));
    hi[at] = h;
    lo[at] = raw - h;
  }
}

// --------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory, zeros where `valid` is false.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- scan
// Tile sizes: HD padded to 64 rows (a warpgroup), ST to 8 columns; row
// strides padded so every fragment load of a warp hits 32 distinct banks.
template <int HD, int ST>
struct Scan {
  static constexpr int HDP = 64;   // one warpgroup: wgmma's 64 rows
  static constexpr int STP = ST < 8 ? 8 : ST;
  static constexpr int WARPS = HDP / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NB = STP / 8;          // 8-column blocks of H
  static constexpr int BS = STP + 8;          // C row stride
  static constexpr int XS = HDP + 8;          // x row stride
  static constexpr int WS = kChunk + 4;       // C·Bᵀ row stride
  // one stage of the double buffer, in floats (16-byte multiples)
  static constexpr int REC = kChunk * kChunk + 2 * STP * kChunk;
  static constexpr int c_off = 0;
  static constexpr int x_off = c_off + kChunk * BS;
  static constexpr int w_off = x_off + kChunk * XS;
  static constexpr int bt_off = w_off + kChunk * WS;   // Bᵀ high, residual
  static constexpr int dt_off = bt_off + 2 * STP * kChunk;
  static constexpr int stage = dt_off + kChunk;
  static constexpr size_t bytes = 2 * stage * sizeof(float);
  static_assert(stage % 4 == 0, "stages stay 16-byte aligned");
};

// Copies chunk `c` (rows t0 .. t0 + kChunk − 1) into one stage.
template <int HD, int ST>
__device__ __forceinline__ void load_chunk(
    float* buf, const float* __restrict__ xb, const float* __restrict__ dtb,
    const float* __restrict__ Cb,
    const float* __restrict__ cbb, int t0, int S, int nh) {
  using P = Scan<HD, ST>;
  constexpr int SQ = P::STP / 4, XQ = P::HDP / 4, WQ = kChunk / 4;
  const int n = min(kChunk, S - t0);
  for (int e = threadIdx.x; e < kChunk * SQ; e += P::THREADS) {
    const int r = e / SQ, q = e % SQ;
    const bool ok = r < n && 4 * q < ST;
    const int64_t g = ok ? (int64_t)(t0 + r) * ST + 4 * q : 0;
    cp16(buf + P::c_off + r * P::BS + 4 * q, Cb + g, ok);
  }
  const int64_t row = (int64_t)nh * HD;
  for (int e = threadIdx.x; e < kChunk * XQ; e += P::THREADS) {
    const int r = e / XQ, q = e % XQ;
    const bool ok = r < n && 4 * q < HD;
    cp16(buf + P::x_off + r * P::XS + 4 * q,
         xb + (ok ? (int64_t)(t0 + r) * row + 4 * q : 0), ok);
  }
  for (int e = threadIdx.x; e < kChunk * WQ; e += P::THREADS) {
    const int r = e / WQ, q = e % WQ;
    cp16(buf + P::w_off + r * P::WS + 4 * q, cbb + r * kChunk + 4 * q, true);
  }
  for (int e = threadIdx.x; e < P::STP * kChunk / 2; e += P::THREADS) {
    cp16(buf + P::bt_off + 4 * e, cbb + kChunk * kChunk + 4 * e, true);
  }
  if (threadIdx.x < kChunk) {
    const int r = threadIdx.x;
    cp4(buf + P::dt_off + r, dtb + (r < n ? (int64_t)(t0 + r) * nh : 0),
        r < n);
  }
  cp_commit();
}

template <int HD, int ST>
__global__ void __launch_bounds__(Scan<HD, ST>::THREADS,
                                  384 / Scan<HD, ST>::THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Cm,
                const float* __restrict__ D, const float* __restrict__ cb,
                float* __restrict__ y,
                float* __restrict__ h_out, int S, int nh) {
  using P = Scan<HD, ST>;
  constexpr int NB = P::NB, BS = P::BS, XS = P::XS, WS = P::WS;
  extern __shared__ __align__(16) float smem[];

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = (threadIdx.x >> 5) * 16;     // this warp's rows of H
  const float a = A[head];
  const float dd = D != nullptr ? D[head] : 0.f;
  const int64_t row = (int64_t)nh * HD;       // x and y row stride
  const float* xb = x + (int64_t)b * S * row + (int64_t)head * HD;
  float* yb = y + (int64_t)b * S * row + (int64_t)head * HD;
  const float* dtb = dt + (int64_t)b * S * nh + head;
  const float* Cb = Cm + (int64_t)b * S * ST;
  const int nc = (S + kChunk - 1) / kChunk;
  const float* cbb = cb + (int64_t)b * nc * P::REC;

  // H[d0 + g (+8)][8·nb + 2t (+1)]: hs[nb][0, 1] row g, [2, 3] row g + 8
  float hs[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) hs[i] = 0.f;

  load_chunk<HD, ST>(smem, xb, dtb, Cb, cbb, 0, S, nh);
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    const int n = min(kChunk, S - t0);
    cp_wait_all();
    __syncthreads();   // chunk c is in; every warp is done with chunk c − 1
    if (c + 1 < nc) {
      load_chunk<HD, ST>(smem + ((c + 1) & 1) * P::stage, xb, dtb, Cb,
                         cbb + (int64_t)(c + 1) * P::REC,
                         t0 + kChunk, S, nh);
    }
    const float* buf = smem + (c & 1) * P::stage;
    const uint32_t bt = hopper::smem_addr(buf + P::bt_off);
    const float* cs = buf + P::c_off;
    const float* xs = buf + P::x_off;
    const float* ws = buf + P::w_off;

    // s = cumsum(dt·A) over the chunk's rows, in lanes r and r + 16 (row
    // r = lane % 16); rows past S have dt = 0, so s stays at the last
    // valid row's
    const float dtr = buf[P::dt_off + (lane & 15)];
    float sr = dtr * a;
#pragma unroll
    for (int off = 1; off < kChunk; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, sr, off, kChunk);
      if ((lane & 15) >= off) sr += u;
    }
    const float s_last = __shfl_sync(0xffffffffu, sr, kChunk - 1);
    const float er = expf(sr);                      // exp(s_r)
    const float cr = dtr * expf(s_last - sr);       // state coefficient

    // 1. Yᵀ[d][i] = Σ_n H[d][n]·C[i][n], then scaled by exp(s_i):
    //    A = H from the registers (state index permuted in each block of
    //    8), B = C[i][8kb + 2t, 2t + 1]
    // NP partial sums over the state blocks, so the MMAs form NP
    // independent chains per column block instead of one long one
    constexpr int NP = NB < 4 ? NB : 4;
    float yp[NP][kChunk / 8][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int ib = 0; ib < kChunk / 8; ++ib)
#pragma unroll
        for (int r = 0; r < 4; ++r) yp[p][ib][r] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
      uint32_t ah[4], al[4];
      split(hs[4 * kb + 0], ah[0], al[0]);
      split(hs[4 * kb + 2], ah[1], al[1]);
      split(hs[4 * kb + 1], ah[2], al[2]);
      split(hs[4 * kb + 3], ah[3], al[3]);
#pragma unroll
      for (int ib = 0; ib < kChunk / 8; ++ib) {
        const float2 cv = *reinterpret_cast<const float2*>(
            cs + (8 * ib + g) * BS + 8 * kb + 2 * t);
        uint32_t bh[2], bl[2];
        split(cv.x, bh[0], bl[0]);
        split(cv.y, bh[1], bl[1]);
        mma_3xtf32(yp[kb % NP][ib], ah, al, bh, bl);
      }
    }
    float yt[kChunk / 8][4];
#pragma unroll
    for (int ib = 0; ib < kChunk / 8; ++ib)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        yt[ib][r] = yp[0][ib][r];
#pragma unroll
        for (int p = 1; p < NP; ++p) yt[ib][r] += yp[p][ib][r];
      }
#pragma unroll
    for (int ib = 0; ib < kChunk / 8; ++ib) {
      const float e0 = __shfl_sync(0xffffffffu, er, 8 * ib + 2 * t);
      const float e1 = __shfl_sync(0xffffffffu, er, 8 * ib + 2 * t + 1);
      yt[ib][0] *= e0;
      yt[ib][1] *= e1;
      yt[ib][2] *= e0;
      yt[ib][3] *= e1;
    }

    // the A operand of steps 2 and 3: x[j][d0 + g (+8)] at j = 8kb + t
    // (+4), raw and times the state coefficient of row j
    float xa[kChunk / 8][4];
#pragma unroll
    for (int kb = 0; kb < kChunk / 8; ++kb) {
      const float* xr = xs + (8 * kb + t) * XS + d0 + g;
      xa[kb][0] = xr[0];
      xa[kb][1] = xr[8];
      xa[kb][2] = xr[4 * XS];
      xa[kb][3] = xr[4 * XS + 8];
    }

    // 3. H ← exp(s_last)·H + Σ_j (coef_j·x[j][d])·B[j][n] on wgmma
    //    (m64n{STP}k8, TF32 three times): A = coef·x from the registers,
    //    B = Bᵀ from the pre-pass's image; waited for at the chunk's end,
    //    so it runs under step 2 and the stores
    const float decay = expf(s_last);
#pragma unroll
    for (int i = 0; i < NB * 4; ++i) hs[i] *= decay;
    uint32_t uh[kChunk / 8][4], ul[kChunk / 8][4];
#pragma unroll
    for (int kb = 0; kb < kChunk / 8; ++kb) {
      const float c0 = __shfl_sync(0xffffffffu, cr, 8 * kb + t);
      const float c1 = __shfl_sync(0xffffffffu, cr, 8 * kb + t + 4);
      split(xa[kb][0] * c0, uh[kb][0], ul[kb][0]);
      split(xa[kb][1] * c0, uh[kb][1], ul[kb][1]);
      split(xa[kb][2] * c1, uh[kb][2], ul[kb][2]);
      split(xa[kb][3] * c1, uh[kb][3], ul[kb][3]);
    }
    hopper::fence_regs(hs);
    hopper::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kChunk / 8; ++kb) {
      const uint64_t dh = hopper::gmma_desc_interleave(bt + kb * 256, 128,
                                                       32 * kChunk);
      const uint64_t dl = hopper::gmma_desc_interleave(
          bt + 4 * P::STP * kChunk + kb * 256, 128, 32 * kChunk);
      hopper::wgmma_tf32_rs<P::STP>(hs, ul[kb], dh);
      hopper::wgmma_tf32_rs<P::STP>(hs, uh[kb], dl);
      hopper::wgmma_tf32_rs<P::STP>(hs, uh[kb], dh);
    }
    hopper::wgmma_commit();

    // 2. Yᵀ[d][i] += Σ_{j <= i} x[j][d]·W[i][j], W[i][j] = C·Bᵀ[i][j]·
    //    exp(s_i − s_j)·dt_j, built in the B fragment (j = 8kb + t (+4),
    //    i = 8ib + g); the blocks above the diagonal are skipped
#pragma unroll
    for (int kb = 0; kb < kChunk / 8; ++kb) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split(xa[kb][r], ah[r], al[r]);
      const int j0 = 8 * kb + t, j1 = j0 + 4;
      const float sj0 = __shfl_sync(0xffffffffu, sr, j0);
      const float sj1 = __shfl_sync(0xffffffffu, sr, j1);
      const float dj0 = __shfl_sync(0xffffffffu, dtr, j0);
      const float dj1 = __shfl_sync(0xffffffffu, dtr, j1);
#pragma unroll
      for (int ib = kb; ib < kChunk / 8; ++ib) {
        const int i = 8 * ib + g;
        const float si = __shfl_sync(0xffffffffu, sr, i);
        const float w0 = j0 <= i ? ws[i * WS + j0] * expf(si - sj0) * dj0
                                 : 0.f;
        const float w1 = j1 <= i ? ws[i * WS + j1] * expf(si - sj1) * dj1
                                 : 0.f;
        uint32_t bh[2], bl[2];
        split(w0, bh[0], bl[0]);
        split(w1, bh[1], bl[1]);
        mma_3xtf32(yt[ib], ah, al, bh, bl);
      }
    }

    // y[i][d] = Yᵀ[d][i] + D·x[i][d], rows i < n and columns d < HD
#pragma unroll
    for (int ib = 0; ib < kChunk / 8; ++ib) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * ib + 2 * t + (r & 1);
        const int d = d0 + g + 8 * (r >> 1);
        if (i < n && d < HD) {
          yb[(int64_t)(t0 + i) * row + d] =
              yt[ib][r] + dd * xs[i * XS + d];
        }
      }
    }

    hopper::wgmma_wait<0>();
    hopper::fence_regs(hs);
    hopper::fence_regs(uh);
    hopper::fence_regs(ul);
  }

  // the final state, rows d < HD and columns n < ST
  float* hb = h_out + ((int64_t)b * nh + head) * HD * ST;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int d = d0 + g + 8 * (r >> 1);
      const int k = 8 * nb + 2 * t + (r & 1);
      if (d < HD && k < ST) hb[d * ST + k] = hs[4 * nb + r];
    }
  }
}

template <int HD, int ST>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* cb, void* y, void* h, int Bt,
           int S, int nh, cudaStream_t stream) {
  using P = Scan<HD, ST>;
  auto kernel = ssd_scan_kernel<HD, ST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && P::bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  }
  if (err != cudaSuccess) return (int)err;
  const int nc = (S + kChunk - 1) / kChunk;
  ssd_cb_kernel<ST><<<dim3(nc, Bt), kChunk * kChunk, 0, stream>>>(
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(cb), S);
  kernel<<<dim3(nh, Bt), P::THREADS, P::bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(C),
      static_cast<const float*>(D), static_cast<const float*>(cb),
      static_cast<float*>(y),
      static_cast<float*>(h), S, nh);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Bt, S, nh, hd], dt [Bt, S, nh], A [nh], B and C [Bt, S, st], D [nh]
// or null, all fp32, contiguous and 16-byte aligned; cb a workspace of
// Bt·ceil(S / 16)·256 floats; writes y [Bt, S, nh, hd] and h
// [Bt, nh, hd, st].
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* D,
                              void* cb, void* y, void* h, int Bt, int S,
                              int nh, int hd, int st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt <= 0 || S <= 0 || nh <= 0 || Bt > 65535) {
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_SSD_CASE(HD, ST)                                          \
  if (hd == HD && st == ST) {                                           \
    return launch<HD, ST>(x, dt, A, B, C, D, cb, y, h, Bt, S, nh, s);   \
  }
  REPRO_SSD_CASE(8, 4)
  REPRO_SSD_CASE(32, 8)
  REPRO_SSD_CASE(32, 16)
  REPRO_SSD_CASE(32, 128)
  REPRO_SSD_CASE(64, 16)
  REPRO_SSD_CASE(64, 32)
  REPRO_SSD_CASE(64, 128)
#undef REPRO_SSD_CASE
  return (int)cudaErrorInvalidValue;
}
