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
// and loops over the chunks itself, with H in shared memory for the whole
// loop. x [Bt, S, nh, hd] and dt [Bt, S, nh] are read as they lie (row
// strides nh·hd and nh): no transpose copy. B and C [Bt, S, st] are
// shared by every head (one group).
//
// Bound, at the Mamba2-2.7B serve shape (Bt 4, S 2048, nh 80, hd 64,
// st 128), counted for the chunked algorithm at the reference kernel's
// chunk of 128 whatever implements it: C·Bᵀ once per (batch, chunk),
// 2·cl²·st; per (batch, head, chunk) the causal half of W·u, cl²·hd, C·Hᵀ,
// 2·cl·st·hd, and the state update, 2·cl·hd·st: 27.1 GFLOP, 0.40 ms at
// 67 TFLOP/s fp32. Bytes: x and y once each, B, C, dt and H, 357 MB,
// 0.11 ms at 3.35 TB/s. Bound by operations.
//
// Design (a simple first kernel; sharing C·Bᵀ across heads, a parallel
// pass over chunk states and tensor cores are for later work):
//   * one block of 256 threads per (head, batch): 320 blocks at the
//     Mamba2 shape, 200 at Hymba's (nh 50, hd 64, st 16);
//   * a chunk of kChunk = 32 rows (one per lane of a warp, so warp 0 takes
//     the cumsum with shuffles) is staged in shared memory: x, B, C, dt;
//     rows at or past S are staged as zeros, so a ragged last chunk adds
//     nothing (u = 0 there), its s stays at the last valid row's, and its
//     rows are not written: any S >= 1 works;
//   * four products per chunk, each a register-tiled loop over shared
//     memory in fp32 FMAs on the CUDA cores (C·Bᵀ → W, W·x, C·Hᵀ, the
//     state update); neighbouring lanes own neighbouring output columns,
//     and B, C and H rows are padded to an odd stride, so no load has a
//     bank conflict;
//   * exp(sᵢ − sⱼ) is evaluated only for j <= i, where sᵢ − sⱼ <= 0 (A < 0,
//     dt >= 0), and always from the difference, never as exp(sᵢ)·exp(−sⱼ):
//     the upper half would overflow to inf, and inf·0 is NaN;
//   * shared memory: 79 KB at (hd 64, st 128), so two blocks fit an SM
//     (the launch bounds cap registers at 128 a thread to match); above
//     48 KB the launch sets the dynamic limit first and returns its
//     error code if that fails.
//
// Supported (hd, st): (8, 4), (32, 8), (32, 16), (32, 128), (64, 16),
// (64, 32), (64, 128) — the shapes of the tests and of the ssm and hybrid
// configs, reduced and full; anything else returns cudaErrorInvalidValue.
//
// C interface (ctypes): repro_ssd_scan returns cudaGetLastError() after
// the launch (or the error of cudaFuncSetAttribute); the caller raises on
// a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // rows per chunk: one per lane of a warp

// A thread's share of an M × N product: NC threads across the columns
// (neighbouring lanes, neighbouring columns), NR down the rows; a thread
// owns TM rows (strided by NR) × TN columns (strided by NC). When M < NR
// the threads with row index >= M sit out.
template <int M, int N>
struct Tile {
  static constexpr int NC = N >= 32 ? 32 : N;
  static constexpr int TN = N / NC;
  static constexpr int NR = kThreads / NC;
  static constexpr int TM = M >= NR ? M / NR : 1;
  static_assert(N % NC == 0, "columns must split evenly over the lanes");
  static_assert(M < NR || M % NR == 0, "rows must split evenly");
};

// Shared-memory layout in floats. B, C and H rows have the odd stride
// ST + 1 and W rows kChunk + 1, so lanes that walk down a column hit
// distinct banks.
template <int HD, int ST>
struct Layout {
  static constexpr int BS = ST + 1;
  static constexpr int WS = kChunk + 1;
  static constexpr int x_off = 0;                     // x   [kChunk][HD]
  static constexpr int b_off = x_off + kChunk * HD;   // B   [kChunk][BS]
  static constexpr int c_off = b_off + kChunk * BS;   // C   [kChunk][BS]
  static constexpr int w_off = c_off + kChunk * BS;   // W   [kChunk][WS]
  static constexpr int h_off = w_off + kChunk * WS;   // H   [HD][BS]
  static constexpr int v_off = h_off + HD * BS;       // dt, s, exp(s), coef
  static constexpr int floats = v_off + 4 * kChunk;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int HD, int ST>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                float* __restrict__ y, float* __restrict__ h_out, int S,
                int nh) {
  using L = Layout<HD, ST>;
  constexpr int BS = L::BS, WS = L::WS;
  extern __shared__ float smem[];
  float* xs = smem + L::x_off;
  float* bs = smem + L::b_off;
  float* cs = smem + L::c_off;
  float* ws = smem + L::w_off;
  float* hs = smem + L::h_off;
  float* dts = smem + L::v_off;     // dt of each row (0 past S)
  float* ss = dts + kChunk;         // s = cumsum(dt·A)
  float* es = ss + kChunk;          // exp(s)
  float* co = es + kChunk;          // dt_j·exp(s_last − s_j)

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[head];
  const float dd = D != nullptr ? D[head] : 0.f;
  const int64_t row = (int64_t)nh * HD;  // x and y row stride
  const float* xb = x + (int64_t)b * S * row + (int64_t)head * HD;
  float* yb = y + (int64_t)b * S * row + (int64_t)head * HD;
  const float* dtb = dt + (int64_t)b * S * nh + head;
  const float* Bb = Bm + (int64_t)b * S * ST;
  const float* Cb = Cm + (int64_t)b * S * ST;

  for (int e = tid; e < HD * BS; e += kThreads) hs[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);  // valid rows of this chunk

    // 1. stage the chunk; rows past S are zeros
    for (int e = tid; e < kChunk * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      xs[e] = r < n ? xb[(int64_t)(t0 + r) * row + c] : 0.f;
    }
    for (int e = tid; e < kChunk * ST; e += kThreads) {
      const int r = e / ST, c = e % ST;
      const int64_t g = (int64_t)(t0 + r) * ST + c;
      bs[r * BS + c] = r < n ? Bb[g] : 0.f;
      cs[r * BS + c] = r < n ? Cb[g] : 0.f;
    }
    if (tid < kChunk) dts[tid] = tid < n ? dtb[(int64_t)(t0 + tid) * nh] : 0.f;
    __syncthreads();

    // 2. s = cumsum(dt·A): warp 0, one row per lane
    if (tid < 32) {
      const float d = dts[tid];
      float v = d * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      const float last = __shfl_sync(0xffffffffu, v, 31);
      ss[tid] = v;
      es[tid] = expf(v);
      co[tid] = d * expf(last - v);  // last − v <= 0
    }
    __syncthreads();

    // 3. W[i][j] = (C Bᵀ)[i][j] · exp(s_i − s_j) · dt_j for j <= i, else 0
    {
      using T = Tile<kChunk, kChunk>;
      const int tc = tid % T::NC, tr = tid / T::NC;
      if (tr < kChunk) {
        float acc[T::TM][T::TN] = {};
        for (int k = 0; k < ST; ++k) {
          float bv[T::TN];
#pragma unroll
          for (int q = 0; q < T::TN; ++q) bv[q] = bs[(tc + T::NC * q) * BS + k];
#pragma unroll
          for (int p = 0; p < T::TM; ++p) {
            const float cv = cs[(tr + T::NR * p) * BS + k];
#pragma unroll
            for (int q = 0; q < T::TN; ++q) acc[p][q] += cv * bv[q];
          }
        }
#pragma unroll
        for (int p = 0; p < T::TM; ++p) {
#pragma unroll
          for (int q = 0; q < T::TN; ++q) {
            const int i = tr + T::NR * p, j = tc + T::NC * q;
            float w = 0.f;
            if (j <= i) w = acc[p][q] * expf(ss[i] - ss[j]) * dts[j];
            ws[i * WS + j] = w;
          }
        }
      }
    }
    __syncthreads();

    // 4. y = W x + exp(s)·(C Hᵀ) + D·x, rows < n written
    {
      using T = Tile<kChunk, HD>;
      const int tc = tid % T::NC, tr = tid / T::NC;
      if (tr < kChunk) {
        float intra[T::TM][T::TN] = {};
        float inter[T::TM][T::TN] = {};
        for (int j = 0; j < kChunk; ++j) {
          float xv[T::TN];
#pragma unroll
          for (int q = 0; q < T::TN; ++q) xv[q] = xs[j * HD + tc + T::NC * q];
#pragma unroll
          for (int p = 0; p < T::TM; ++p) {
            const float wv = ws[(tr + T::NR * p) * WS + j];
#pragma unroll
            for (int q = 0; q < T::TN; ++q) intra[p][q] += wv * xv[q];
          }
        }
        for (int k = 0; k < ST; ++k) {
          float hv[T::TN];
#pragma unroll
          for (int q = 0; q < T::TN; ++q) hv[q] = hs[(tc + T::NC * q) * BS + k];
#pragma unroll
          for (int p = 0; p < T::TM; ++p) {
            const float cv = cs[(tr + T::NR * p) * BS + k];
#pragma unroll
            for (int q = 0; q < T::TN; ++q) inter[p][q] += cv * hv[q];
          }
        }
#pragma unroll
        for (int p = 0; p < T::TM; ++p) {
          const int i = tr + T::NR * p;
          if (i >= n) continue;
#pragma unroll
          for (int q = 0; q < T::TN; ++q) {
            const int d = tc + T::NC * q;
            yb[(int64_t)(t0 + i) * row + d] =
                intra[p][q] + es[i] * inter[p][q] + dd * xs[i * HD + d];
          }
        }
      }
    }
    __syncthreads();  // every read of the old H is done

    // 5. H ← exp(s_last)·H + Σ_j co_j · x_j ⊗ B_j (each thread its own
    //    entries of H)
    {
      using T = Tile<HD, ST>;
      const int tc = tid % T::NC, tr = tid / T::NC;
      if (tr < HD) {
        float acc[T::TM][T::TN] = {};
        for (int j = 0; j < kChunk; ++j) {
          const float cj = co[j];
          float bv[T::TN];
#pragma unroll
          for (int q = 0; q < T::TN; ++q) bv[q] = bs[j * BS + tc + T::NC * q];
#pragma unroll
          for (int p = 0; p < T::TM; ++p) {
            const float xv = xs[j * HD + tr + T::NR * p] * cj;
#pragma unroll
            for (int q = 0; q < T::TN; ++q) acc[p][q] += xv * bv[q];
          }
        }
        const float decay = expf(ss[kChunk - 1]);
#pragma unroll
        for (int p = 0; p < T::TM; ++p) {
#pragma unroll
          for (int q = 0; q < T::TN; ++q) {
            float* hp = hs + (tr + T::NR * p) * BS + tc + T::NC * q;
            *hp = *hp * decay + acc[p][q];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites x, B and C
  }

  float* hb = h_out + ((int64_t)b * nh + head) * HD * ST;
  for (int e = tid; e < HD * ST; e += kThreads) {
    hb[e] = hs[(e / ST) * BS + e % ST];
  }
}

template <int HD, int ST>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* h, int Bt, int S,
           int nh, cudaStream_t stream) {
  constexpr size_t bytes = Layout<HD, ST>::bytes;
  auto kernel = ssd_scan_kernel<HD, ST>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(nh, Bt), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(h), S, nh);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Bt, S, nh, hd], dt [Bt, S, nh], A [nh], B and C [Bt, S, st], D [nh]
// or null, all fp32 and contiguous; writes y [Bt, S, nh, hd] and h
// [Bt, nh, hd, st].
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* D,
                              void* y, void* h, int Bt, int S, int nh,
                              int hd, int st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt <= 0 || S <= 0 || nh <= 0 || Bt > 65535) {
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_SSD_CASE(HD, ST)                                          \
  if (hd == HD && st == ST) {                                           \
    return launch<HD, ST>(x, dt, A, B, C, D, y, h, Bt, S, nh, s);       \
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
