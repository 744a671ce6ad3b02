// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:ssd_pallas
// (_ssd_kernel, pallas_call at :79). It computes the same function:
// for x (B,S,H,P) bf16, dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,N) bf16,
// with S a multiple of the chunk L,
//
//   y_i   = sum_{j<=i in chunk} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//           + exp(cums_i) C_i . st_before(chunk)
//   st'   = exp(cums_L) st + sum_j dt_j exp(cums_L - cums_j) x_j B_j^T
//
// (cums = the running sum of dt * A inside the chunk), returning y
// (B,S,H,P) f32 and the final state (B,H,P,N) f32, with every product
// exact and every sum in fp32.
//
// The TPU grid (B, H, chunks) runs the chunk axis in order with the state
// in VMEM: B*H = 96 independent programs at the model's prefill shape,
// under one wave of this card's 132 SMs. Here the chunks run in parallel
// and only a short elementwise pass is sequential over them. Two routes
// compute it; the wrapper (kernel.py, takes_tensor_cores) picks one by a
// stated rule.
//
// * The tensor-core route (namespace tc, ssd_tc_launch), for L a
//   multiple of 64 up to 256, P a multiple of 8 up to 64, N 128 (every
//   Mamba2 config's) and 16-byte aligned x, Bm, Cm (what TMA needs):
//   three kernels,
//     1. ssd_chunk_state_tc_kernel  block per (h, chunk, b): the chunk's
//        scan of dt*A, its decay exp(cums_L), and its own state
//        contribution (w x)^T B (P x N, w_l = dt_l exp(cums_L - cums_l));
//     2. ssd_state_pass_tc_kernel   thread per (b, h, 4 of the P*N
//        cells): walks the chunks, its loads issued 16 chunks at a time
//        before the recurrence consumes them, writing each chunk's
//        "state before" as bf16 hi and lo and the final state in fp32;
//     3. ssd_output_tc_kernel       block per (h, chunk, b), one
//        warpgroup per 64-row tile of the chunk, the whole chunk loaded
//        once into shared memory: flash attention with another
//        elementwise step (C plays q, Bm k, x v).
//   Every product runs on the bf16 tensor cores (wgmma) from 128-byte
//   swizzled tiles that TMA loads. A product of two bf16 values is exact
//   in fp32, so C.B^T is exact as it stands. The three products with
//   an fp32 factor (att.x, (w x)^T B and C.st) split it
//   into v_hi = bf16(v) and v_lo = bf16(v - v_hi) (v - v_hi is exact in
//   fp32 and v_lo leaves at most 2^-17 |v|), so each is two bf16
//   products with fp32 sums: the same function as the fp32 product to
//   ~1e-5 relative, where one bf16 term would move y ~30x past the
//   1e-3 + 1e-3 |ref| tolerance (tests/test_torch_ssd_design.py models
//   both). The chunk's scan runs in float64 (chunk_cumsum says why).
// * The CUDA-core route (the first design, ssd_launch), for every other
//   shape: four kernels on the fp32 CUDA cores, ssd_chunk_state_kernel,
//   ssd_cb_kernel (C.B^T once per chunk, shared by the heads),
//   ssd_state_pass_kernel and ssd_output_kernel.
//
// Bound at the model's prefill shape (B 4, S 4096, H 24, P 64, N 128,
// L 256): ~164 MB of operands, 0.049 ms at 3.35 TB/s. On the bf16 tensor
// cores (989 TFLOP/s) the work is C.B^T (its causal half, once per
// chunk) and att.x, (w x)^T B and C.st twice each (hi and lo): 19.2 G
// multiply-adds, 0.039 ms; so bytes bound it. On the fp32 CUDA cores
// (67 TFLOP/s) the same function is 9.75 G multiply-adds, 0.291 ms.
// What the tensor-core route moves beyond the operands is its scratch:
// each chunk's fp32 contribution (written, then read by the pass) and
// the bf16 hi/lo states before each chunk (written, then read by the
// output kernel), ~150 MB at this shape. What holds it back (PERF.md
// §6): the output kernel, one block an SM, waits ~1.5 us for its first
// tiles, its warpgroups share the tensor cores unevenly (the last row
// tile has four key tiles, the first one), and it recomputes C.B^T for
// every head. The pass runs near its bytes, the chunk states at about
// twice theirs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Inclusive scan of dt[b, t0 + l, h] * a over l < L into cums[l], by the
// whole block of NT threads; dts[l] receives dt. Ends with a barrier.
// The scan runs in float64: the kernels take exp of differences
// cums_i - cums_j, and in fp32 each cums carries an absolute error of
// ~|cums| 2^-24, which under strong decay (|cums| ~ 1e4 within a chunk)
// moves a term by ~1e-3 of itself. Each difference is rounded to fp32
// before the fp32 exp.
template <int NT>
__device__ void chunk_cumsum(const float* __restrict__ dt, float a,
                             int64_t t0, int H, int h, int L, double* cums,
                             float* dts) {
  constexpr int kWarps = NT / 32;
  __shared__ double warp_tot[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double carry = 0.0;
  for (int base = 0; base < L; base += NT) {
    const int l = base + tid;
    float d = 0.f;
    if (l < L) {
      d = dt[(t0 + l) * H + h];
      dts[l] = d;
    }
    double v = (double)d * a;  // exact
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double w = lane < kWarps ? warp_tot[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += n;
      }
      if (lane < kWarps) warp_tot[lane] = w;
    }
    __syncthreads();
    if (l < L) cums[l] = carry + (warp > 0 ? warp_tot[warp - 1] : 0.0) + v;
    carry += warp_tot[kWarps - 1];
    __syncthreads();  // warp_tot is rewritten by the next segment
  }
}

// ---------------------------------------------------- CUDA-core route ----

// 1. Per chunk: its decay and its contribution to the state,
//    states[b, c, h] = sum_j dt_j exp(cums_L - cums_j) x_j B_j^T  (P x N).
//    Output tiles of 64 (p) x 128 (n); each thread holds 4 x 8.
__global__ void __launch_bounds__(kThreads) ssd_chunk_state_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ dec, int S, int H, int P,
    int N, int L) {
  extern __shared__ float dyn[];
  double* cums = reinterpret_cast<double*>(dyn);  // L doubles
  float* w = dyn + 2 * L;
  __shared__ float xs[32][64];
  __shared__ float bs[32][128];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  chunk_cumsum<kThreads>(dt, A[h], t0, H, h, L, cums, w);
  const double last = cums[L - 1];
  for (int l = threadIdx.x; l < L; l += kThreads)
    w[l] = w[l] * expf((float)(last - cums[l]));
  if (threadIdx.x == 0)
    dec[((int64_t)b * nc + c) * H + h] = expf((float)last);
  __syncthreads();

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* out = states + (((int64_t)b * nc + c) * H + h) * P * N;
  for (int p0 = 0; p0 < P; p0 += 64) {
    for (int n0 = 0; n0 < N; n0 += 128) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
      for (int l0 = 0; l0 < L; l0 += 32) {
        for (int e = threadIdx.x; e < 32 * 64; e += kThreads) {
          const int r = e / 64, col = e % 64, l = l0 + r, p = p0 + col;
          xs[r][col] = (l < L && p < P)
                           ? ld(x[((t0 + l) * H + h) * P + p]) * w[l]
                           : 0.f;
        }
        for (int e = threadIdx.x; e < 32 * 128; e += kThreads) {
          const int r = e / 128, col = e % 128, l = l0 + r, n = n0 + col;
          bs[r][col] = (l < L && n < N) ? ld(Bm[(t0 + l) * N + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < 32; ++r) {
          float av[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = xs[r][ty * 4 + i];
#pragma unroll
          for (int k = 0; k < 8; ++k) bv[k] = bs[r][tx + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[i][k] += av[i] * bv[k];
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty * 4 + i;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = n0 + tx + 16 * k;
          if (p < P && n < N) out[(int64_t)p * N + n] = acc[i][k];
        }
      }
    }
  }
}

// 2. cb[b, c, i, j] = C_i . B_j for j <= i (tiles wholly above the
//    diagonal are skipped: nothing reads them). 64 x 64 tiles, 4 x 4 a
//    thread; rows padded to 33 floats against bank conflicts.
__global__ void __launch_bounds__(kThreads) ssd_cb_kernel(
    const __nv_bfloat16* __restrict__ Cm,
    const __nv_bfloat16* __restrict__ Bm, float* __restrict__ cb, int S,
    int N, int L) {
  const int ntile = (L + 63) / 64;
  const int ti = blockIdx.x / ntile, tj = blockIdx.x % ntile;
  if (tj > ti) return;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  __shared__ float cs[64][33];
  __shared__ float bs[64][33];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
  for (int n0 = 0; n0 < N; n0 += 32) {
    for (int e = threadIdx.x; e < 64 * 32; e += kThreads) {
      const int r = e / 32, k = e % 32, n = n0 + k;
      const int i = ti * 64 + r, j = tj * 64 + r;
      cs[r][k] = (i < L && n < N) ? ld(Cm[(t0 + i) * N + n]) : 0.f;
      bs[r][k] = (j < L && n < N) ? ld(Bm[(t0 + j) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = cs[ty * 4 + i][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[tx + 16 * q][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += av[i] * bv[q];
    }
    __syncthreads();
  }
  float* out = cb + ((int64_t)b * nc + c) * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ti * 64 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = tj * 64 + tx + 16 * q;
      if (row < L && col < L) out[(int64_t)row * L + col] = acc[i][q];
    }
  }
}

// 3. The pass over chunks, one thread per (b, h, p, n): states[b, c, h]
//    becomes the state before chunk c; the state after the last chunk is
//    the final state (B, H, P, N).
__global__ void __launch_bounds__(kThreads) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ dec,
    float* __restrict__ final_state, int B, int nc, int H, int PN) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * H * PN) return;
  const int64_t pn = e % PN, bh = e / PN;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float st = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int64_t bc = ((int64_t)b * nc + c) * H + h;
    const float s = states[bc * PN + pn];
    states[bc * PN + pn] = st;
    st = dec[bc] * st + s;
  }
  final_state[e] = st;
}

// 4. Outputs of 64 rows i of chunk c for head h, all p (64 at a time):
//    the intra-chunk product att.x with att_ij = cb_ij exp(cums_i -
//    cums_j) dt_j for j <= i (the exponent is never positive: A < 0), plus
//    exp(cums_i) C_i . st_before for every chunk but the first.
__global__ void __launch_bounds__(kThreads) ssd_output_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ states, const float* __restrict__ cb,
    float* __restrict__ y, int S, int H, int P, int N, int L) {
  extern __shared__ float dyn[];
  double* cums = reinterpret_cast<double*>(dyn);  // L doubles
  float* dts = dyn + 2 * L;
  __shared__ float as[64][33];
  __shared__ float vs[32][65];
  const int ntile = (L + 63) / 64;
  const int h = blockIdx.x, c = blockIdx.y / ntile, ti = blockIdx.y % ntile;
  const int b = blockIdx.z, nc = gridDim.y / ntile;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  chunk_cumsum<kThreads>(dt, A[h], t0, H, h, L, cums, dts);
  const int i0 = ti * 64;
  const int i_end = min(L, i0 + 64);
  const float* cbc = cb + ((int64_t)b * nc + c) * L * L;
  const float* st = states + (((int64_t)b * nc + c) * H + h) * P * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  for (int p0 = 0; p0 < P; p0 += 64) {
    float acc[4][4], inter[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = inter[i][q] = 0.f;

    for (int j0 = 0; j0 < i_end; j0 += 32) {
      for (int e = threadIdx.x; e < 64 * 32; e += kThreads) {
        const int r = e / 32, k = e % 32, i = i0 + r, j = j0 + k;
        float v = 0.f;
        if (i < L && j <= i)
          v = cbc[(int64_t)i * L + j] * expf((float)(cums[i] - cums[j])) *
              dts[j];
        as[r][k] = v;
      }
      for (int e = threadIdx.x; e < 32 * 64; e += kThreads) {
        const int r = e / 64, col = e % 64, j = j0 + r, p = p0 + col;
        vs[r][col] = (j < L && p < P) ? ld(x[((t0 + j) * H + h) * P + p])
                                      : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[ty * 4 + i][k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = vs[k][tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] += av[i] * bv[q];
      }
      __syncthreads();
    }

    if (c > 0) {  // the state before the first chunk is zero
      for (int n0 = 0; n0 < N; n0 += 32) {
        for (int e = threadIdx.x; e < 64 * 32; e += kThreads) {
          const int r = e / 32, k = e % 32, i = i0 + r, n = n0 + k;
          as[r][k] = (i < L && n < N) ? ld(Cm[(t0 + i) * N + n]) : 0.f;
        }
        // st is (P, N) with n fastest: read along n, store transposed
        for (int e = threadIdx.x; e < 32 * 64; e += kThreads) {
          const int k = e % 32, col = e / 32, n = n0 + k, p = p0 + col;
          vs[k][col] = (n < N && p < P) ? st[(int64_t)p * N + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = as[ty * 4 + i][k];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = vs[k][tx + 16 * q];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) inter[i][q] += av[i] * bv[q];
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty * 4 + i;
      if (row >= L) continue;
      const float d = expf((float)cums[row]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + tx + 16 * q;
        if (p < P) y[((t0 + row) * H + h) * P + p] = acc[i][q] + d * inter[i][q];
      }
    }
  }
}

// ------------------------------------------------- tensor-core route ----

namespace tc {

using namespace hopper;

constexpr int kThreads = 128;         // one warpgroup
constexpr int T = 64;                 // rows of a tile (l, i or j)
constexpr uint32_t PANEL = 64 * 128;  // 64 rows of 64 bf16, 128B-swizzled
constexpr int N = 128;                // the state's width: two panels
constexpr int NP = N / 64;
constexpr int kPassBatch = 16;        // chunk loads a thread has in flight

// In the accumulator of an m64nNk16 wgmma, thread (warp w, lane 4 g + tq)
// of the warpgroup holds rows 16 w + g and 16 w + g + 8; its register j
// is row (j >> 1) & 1 of the two, column 8 (j >> 2) + 2 tq + (j & 1).
// The A fragment of k step kk (16 columns) is registers 8 kk .. 8 kk + 7
// of such an accumulator as bf16 pairs (register q: 8 kk + 2 q, + 1).

// (a, b) = hi + lo as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 1. Per chunk: its scan (cums and dt into cd, for the output kernel),
//    its decay, and its contribution (w x)^T B to the state (P x N, fp32;
//    w_l = dt_l exp(cums_L - cums_l)). The chunk's rows arrive 64 at a
//    time through two TMA stages: x (64 l x 64 p) and B (64 l x N). The
//    block scales x row by row by w_l and splits it in place into
//    (w x)_hi, with (w x)_lo beside it (the 128-byte swizzle moves 16-byte
//    chunks only within their row, so row l of the tile stays row l);
//    B stays as loaded, exact. Then D += (w x)_hi^T B + (w x)_lo^T B with
//    both operands MN-major ((w x)^T's M = p and B's N = n contiguous),
//    while the next sub-tile is split. D's rows are p and its columns n:
//    the state's own layout.
__global__ void __launch_bounds__(kThreads) ssd_chunk_state_tc_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ dt,
    const float* __restrict__ A, float* __restrict__ states,
    float* __restrict__ dec, float* __restrict__ cd, int S, int H, int P,
    int L) {
  constexpr uint32_t BB = NP * PANEL;          // 64 rows of B
  constexpr uint32_t STAGE = 2 * PANEL + BB;   // (w x)_hi, (w x)_lo, B
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  double* cums = reinterpret_cast<double*>(gbase + 2 * STAGE);
  float* w = reinterpret_cast<float*>(cums + L);
  const uint32_t bars = base + 2 * STAGE + 12 * L;  // stage 0, stage 1
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int r0 = c * L;  // the chunk's first row in b's sequence
  const int nsub = L / T;
  const int tid = threadIdx.x;

  auto load = [&](int u) {  // rows r0 + 64 u .. + 63 into stage u % 2
    const uint32_t st = base + (u & 1) * STAGE, bar = bars + 8 * (u & 1);
    mbar_arrive_expect_tx(bar, PANEL + BB);
    tma_load_4d(st, &tm_x, bar, 0, h, r0 + T * u, b);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load_3d(st + 2 * PANEL + p * PANEL, &tm_b, bar, 64 * p,
                  r0 + T * u, b);
  };
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
    tma_prefetch_map(&tm_x);
    tma_prefetch_map(&tm_b);
    load(0);
    if (nsub > 1) load(1);
  }
  // (its barriers make the mbarrier initialisation visible to the block)
  chunk_cumsum<kThreads>(dt, A[h], (int64_t)b * S + r0, H, h, L, cums, w);
  const double last = cums[L - 1];
  const int64_t bch = ((int64_t)b * nc + c) * H + h;
  // the chunk's scan for the output kernel: L doubles, then L floats (dt)
  float* cdo = cd + bch * 3 * L;
  for (int l = tid; l < L; l += kThreads) {
    reinterpret_cast<double*>(cdo)[l] = cums[l];
    cdo[2 * L + l] = w[l];
    w[l] *= expf((float)(last - cums[l]));
  }
  if (tid == 0) dec[bch] = expf((float)last);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  // (w x) = hi + lo for sub-tile u, row by row, in the swizzled layout
  // TMA wrote; then made visible to the tensor cores
  auto split_x = [&](int u) {
    const uint32_t shi = base + (u & 1) * STAGE;
    uint4* hi4 = reinterpret_cast<uint4*>(gbase + (shi - base));
    uint4* lo4 = reinterpret_cast<uint4*>(gbase + (shi + PANEL - base));
    for (int e = tid; e < 512; e += kThreads) {    // 16-byte chunks
      const float wl = w[T * u + (e >> 3)];        // the chunk's row
      uint4 v = hi4[e], lo;
      uint32_t* vv = reinterpret_cast<uint32_t*>(&v);
      uint32_t* ll = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&vv[q]));
        split2(wl * f.x, wl * f.y, vv[q], ll[q]);
      }
      hi4[e] = v;
      lo4[e] = lo;
    }
    fence_proxy_async();
  };
  mbar_wait(bars, 0);
  split_x(0);
  __syncthreads();
  for (int u = 0; u < nsub; ++u) {
    const int s = u & 1;
    const uint32_t shi = base + s * STAGE, slo = shi + PANEL,
                   sb = shi + 2 * PANEL;
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        // k step kk: rows 16 kk .. of both tiles (8-row groups 1024 apart,
        // 64-column panels PANEL apart)
        const uint64_t da =
            desc_sw128((half ? slo : shi) + kk * 16 * 128, PANEL, 1024);
        const uint64_t db = desc_sw128(sb + kk * 16 * 128, PANEL, 1024);
        wgmma_ss_n128<1, 1>(acc, da, db, 1);
      }
    wgmma_commit();
    if (u + 1 < nsub) {  // the next sub-tile's split beside the products
      mbar_wait(bars + 8 * (s ^ 1), ((u + 1) >> 1) & 1);
      split_x(u + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage s is free; sub-tile u + 1 is split
    if (tid == 0 && u + 2 < nsub) load(u + 2);
  }

  float* out = states + bch * P * N;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int p = 16 * warp + g + 8 * ((j >> 1) & 1);
    const int n = 8 * (j >> 2) + 2 * tq;
    if (p < P)
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(acc[j], acc[j + 1]);
  }
}

// 2. The pass over chunks, one thread per (b, h, 4 consecutive cells of
//    the P x N state). It issues 16 chunks' loads (their contributions and
//    decays) before the recurrence consumes them, so the loads are in
//    flight together instead of a chain of load, FMA, store; it writes
//    the state before each chunk past the first as bf16 hi and lo (the
//    output kernel's B operand: P rows of N) and the final state in fp32.
__global__ void __launch_bounds__(256) ssd_state_pass_tc_kernel(
    const float* __restrict__ states, const float* __restrict__ dec,
    __nv_bfloat16* __restrict__ st2, float* __restrict__ final_state, int B,
    int nc, int H, int PN) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int q4 = PN / 4;
  if (e >= (int64_t)B * H * q4) return;
  const int64_t bh = e / q4, pn = (e % q4) * 4;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float4 add[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < nc) {
        const int64_t bc = ((int64_t)b * nc + c0 + k) * H + h;
        add[k] = __ldg(reinterpret_cast<const float4*>(states + bc * PN + pn));
        d[k] = __ldg(dec + bc);
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int c = c0 + k;
      if (c >= nc) break;
      if (c > 0) {
        const int64_t bc = ((int64_t)b * nc + c) * H + h;
        uint2 hi, lo;
        split2(st.x, st.y, hi.x, lo.x);
        split2(st.z, st.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(st2 + 2 * bc * PN + pn) = hi;
        *reinterpret_cast<uint2*>(st2 + (2 * bc + 1) * PN + pn) = lo;
      }
      st.x = fmaf(d[k], st.x, add[k].x);
      st.y = fmaf(d[k], st.y, add[k].y);
      st.z = fmaf(d[k], st.z, add[k].z);
      st.w = fmaf(d[k], st.w, add[k].w);
    }
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + pn) = st;
}

// 3. Outputs of chunk c for head h, one warpgroup per 64-row tile i0 of
//    the chunk (L / 64 of them, 4 at L = 256):
//      y = sum over 64-key tiles j0 <= i0 of att_hi x_j + att_lo x_j
//        + exp(cums_i) (C_i . st_hi + C_i . st_lo)    (past the first chunk),
//      att_ij = (C_i . B_j) exp(cums_i - cums_j) dt_j for j <= i, else 0.
//    Thread 0 loads the whole chunk once, by TMA: every C and key tile
//    (B_j 64 x N, x_j 64 x 64) and the two state halves (P rows of N
//    each), each behind its own mbarrier, in the order the warpgroups
//    need them (key tile 0 and the heaviest tiles' C first). Every tile
//    of the chunk is read once per head instead of once per row tile
//    that uses it. Each warpgroup then walks its key tiles 0 .. i0:
//    s = C_i B_j^T by wgmma from K-major tiles (exact); the elementwise
//    step in registers, in the stable form exp(cums_i - cums_j) (never
//    exp(cums_i) exp(-cums_j), which overflows for long chunks); att's hi
//    and lo as A fragments and x N-major from shared memory, as p.V in
//    attention.cu. The products are pipelined: s of tile j + 1 is issued
//    before att.x of tile j, and tile j + 1's elementwise step runs while
//    att.x of tile j is on the tensor cores.
__global__ void __launch_bounds__(4 * kThreads, 1) ssd_output_tc_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_c,
    const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_st, const float* __restrict__ cd,
    float* __restrict__ y, int S, int H, int P, int L) {
  constexpr uint32_t CB = NP * PANEL;  // 64 rows of C, B or a state half
  extern __shared__ uint8_t smem_raw[];
  const int ntile = L / T, nc = S / L;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sC = (raw + 1023) & ~1023u;  // C tile i: + i CB
  const uint32_t sB = sC + ntile * CB;         // B tile j: + j CB
  const uint32_t sX = sB + ntile * CB;         // x tile j: + j PANEL
  const uint32_t sSt = sX + ntile * PANEL;     // st_hi, then st_lo
  const uint32_t sCd = sSt + 2 * CB;           // cums (f64), dt, then keyf
  uint8_t* gbase = smem_raw + (sC - raw);
  double* cums = reinterpret_cast<double*>(gbase + (sCd - sC));
  float* dts = reinterpret_cast<float*>(cums + L);
  float* keyf = dts + L;
  // mbarriers: C tile i at bars + 8 i, key tile j at + 8 (ntile + j), the
  // state at + 16 ntile, the chunk's scan at + 8 (2 ntile + 1)
  const uint32_t bars = sCd + 16 * L;
  const uint32_t bar_cd = bars + 8 * (2 * ntile + 1);
  const int h = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int r0 = c * L;
  const int tid = threadIdx.x;
  const int64_t bch = ((int64_t)b * nc + c) * H + h;

  if (tid == 0) {
    for (int k = 0; k < 2 * ntile + 2; ++k) mbar_init(bars + 8 * k, 1);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised before anyone waits
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_cd, 12 * L);
    bulk_load(sCd, cd + bch * 3 * L, 12 * L, bar_cd);
    tma_prefetch_map(&tm_x);
    tma_prefetch_map(&tm_c);
    tma_prefetch_map(&tm_b);
    tma_prefetch_map(&tm_st);
    auto load_key = [&](int j) {
      const uint32_t bar = bars + 8 * (ntile + j);
      mbar_arrive_expect_tx(bar, CB + PANEL);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_3d(sB + j * CB + p * PANEL, &tm_b, bar, 64 * p,
                    r0 + T * j, b);
      tma_load_4d(sX + j * PANEL, &tm_x, bar, 0, h, r0 + T * j, b);
    };
    load_key(0);
    for (int i = ntile - 1; i >= 0; --i) {  // the heaviest tiles first
      mbar_arrive_expect_tx(bars + 8 * i, CB);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_3d(sC + i * CB + p * PANEL, &tm_c, bars + 8 * i, 64 * p,
                    r0 + T * i, b);
    }
    for (int j = 1; j < ntile; ++j) load_key(j);
    if (c > 0) {  // the state before the first chunk is zero
      const uint32_t bar = bars + 16 * ntile;
      mbar_arrive_expect_tx(bar, 2 * CB);
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load_3d(sSt + half * CB + p * PANEL, &tm_st, bar, 64 * p, 0,
                      (int)(2 * bch + half));
    }
  }
  // keyf_l = exp(cums_m - cums_l) dt_l, m the last key of l's tile
  mbar_wait(bar_cd, 0);
  for (int l = tid; l < L; l += blockDim.x)
    keyf[l] = expf((float)(cums[l | (T - 1)] - cums[l])) * dts[l];
  __syncthreads();

  // this warpgroup's row tile (broadcast from lane 0, so that ptxas sees
  // a warp-uniform value and keeps the wgmmas of its loops asynchronous),
  // and the thread's two rows in it
  const int ti = __shfl_sync(0xffffffffu, tid / kThreads, 0), i0 = T * ti;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            tq = lane & 3;
  const int ra = i0 + 16 * warp + g, rb = ra + 8;
  const double ca = cums[ra], cb = cums[rb];
  const uint32_t sCi = sC + ti * CB;
  auto desc_c = [&](int kk) {
    return desc_sw128(sCi + (kk >> 2) * PANEL + (kk & 3) * 32, 16, 1024);
  };
  auto wait_key = [&](int j) { mbar_wait(bars + 8 * (ntile + j), 0); };
  // s = C_i B_j^T, N / 16 k steps (K-major rows of B tile j)
  auto issue_s = [&](float (&sc)[32], int j) {
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss_n64(sc, desc_c(kk),
                   desc_sw128(sB + j * CB + (kk >> 2) * PANEL + (kk & 3) * 32,
                              16, 1024),
                   kk);
  };
  // att in place of s for key tile j. Below the diagonal (j < ti) every
  // key of the tile is valid, and exp(cums_i - cums_j) = exp(cums_i -
  // cums_m) exp(cums_m - cums_j) about the tile's last key m, with both
  // exponents <= 0 (cums falls: dt >= 0, A < 0): nothing overflows, and a
  // factor that underflows leaves a product below e^-87 anyway. On the
  // diagonal tile each element takes exp(cums_i - cums_j) itself.
  auto att = [&](float (&sc)[32], int j) {
    if (j < ti) {
      const double cm = cums[T * j + T - 1];
      const float fa = expf((float)(ca - cm)), fb = expf((float)(cb - cm));
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int key = T * j + 8 * (r >> 2) + 2 * tq + (r & 1);
        sc[r] *= ((r >> 1) & 1 ? fb : fa) * keyf[key];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int key = T * j + 8 * (r >> 2) + 2 * tq + (r & 1);
        const bool second = (r >> 1) & 1;
        const int row = second ? rb : ra;
        const double ci = second ? cb : ca;
        sc[r] = key <= row
                    ? sc[r] * expf((float)(ci - cums[key])) * dts[key]
                    : 0.f;
      }
    }
  };
  // acc += att_hi x + att_lo x for key tile j: x is [64 keys x 64 p]
  // row-major (MN-major for wgmma's B), 8-key groups 1024 bytes apart
  auto issue_x = [&](float (&acc)[32], const uint32_t (&ahi)[4][4],
                     const uint32_t (&alo)[4][4], int j) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64(acc, half ? alo[kk] : ahi[kk],
                     desc_sw128(sX + j * PANEL + kk * 16 * 128, PANEL,
                                1024));
  };
  auto split_att = [&](const float (&sc)[32], uint32_t (&ahi)[4][4],
                       uint32_t (&alo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split2(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1], ahi[kk][q],
               alo[kk][q]);
  };

  float acc[32], sc[32];
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  mbar_wait(bars + 8 * ti, 0);
  wait_key(0);
  wgmma_fence();
  issue_s(sc, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  att(sc, 0);
  for (int j = 0; j < ti; ++j) {
    split_att(sc, ahi, alo);
    wgmma_fence();
    wait_key(j + 1);
    issue_s(sc, j + 1);  // s of the next tile first: sc is free again
    wgmma_commit();
    issue_x(acc, ahi, alo, j);
    wgmma_commit();
    wgmma_wait<1>();     // the next tile's s is done: its elementwise step
    fence_regs(sc);      // runs beside att.x of this one
    att(sc, j + 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }
  split_att(sc, ahi, alo);
  wgmma_fence();
  issue_x(acc, ahi, alo, ti);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  if (c > 0) {  // acc += exp(cums_i) (C_i . st_hi + C_i . st_lo)
    float inter[32];
    mbar_wait(bars + 16 * ntile, 0);
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk)
        wgmma_ss_n64(inter, desc_c(kk),
                     desc_sw128(sSt + half * CB + (kk >> 2) * PANEL +
                                    (kk & 3) * 32,
                                16, 1024),
                     half | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(inter);
    const float ea = expf((float)ca), eb = expf((float)cb);
#pragma unroll
    for (int r = 0; r < 32; ++r)
      acc[r] = fmaf((r >> 1) & 1 ? eb : ea, inter[r], acc[r]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* yrow = y + (((int64_t)b * S + r0 + (r ? rb : ra)) * H + h) * P;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {
      const int col = 8 * n8 + 2 * tq;  // P % 8 == 0: col + 1 < P too
      if (col < P)
        *reinterpret_cast<float2*>(yrow + col) =
            make_float2(acc[4 * n8 + 2 * r], acc[4 * n8 + 2 * r + 1]);
    }
  }
}

cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mb,
                   const CUtensorMap& mc, const CUtensorMap& mst,
                   const float* dt, const float* A, float* y,
                   float* final_state, float* states, __nv_bfloat16* st2,
                   float* dec, float* cd, int B, int S, int H, int P, int L,
                   cudaStream_t stream) {
  const int nc = S / L;
  const size_t smem1 = 1024 + 2 * (size_t)(2 * PANEL + NP * PANEL) +
                       12 * (size_t)L + 2 * 8;
  const int ntile = L / T;
  const size_t smem3 = 1024 + (size_t)ntile * (2 * NP * PANEL + PANEL) +
                       2 * (size_t)NP * PANEL + 16 * (size_t)L +
                       8 * (size_t)(2 * ntile + 2);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_output_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_tc_kernel<<<dim3(H, nc, B), kThreads, smem1, stream>>>(
      mx, mb, dt, A, states, dec, cd, S, H, P, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t threads = (int64_t)B * H * P * N / 4;
  ssd_state_pass_tc_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                             stream>>>(states, dec, st2, final_state, B, nc,
                                       H, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_tc_kernel<<<dim3(H, B * nc), ntile * kThreads, smem3,
                             stream>>>(mx, mc, mb, mst, cd, y, S, H, P, L);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// The CUDA-core route: runs its four kernels in order on `stream`.
// Scratch and outputs are allocated by the caller: states (B, S/L, H, P,
// N), dec (B, S/L, H) and cb (B, S/L, L, L), all f32. Returns 0 or the
// first launch error.
int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* final_state, void* states,
               void* dec, void* cb, int B, int S, int H, int P, int N, int L,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cbm = static_cast<const __nv_bfloat16*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  auto* st = static_cast<float*>(states);
  auto* dc = static_cast<float*>(dec);
  auto* cbf = static_cast<float*>(cb);
  const int nc = S / L;
  const int ntile = (L + 63) / 64;
  const size_t dyn = 3 * (size_t)L * sizeof(float);  // cums f64, dt f32
  cudaError_t err;
  // up to 24 KB of dynamic beside the static shared memory
  if ((err = cudaFuncSetAttribute(
           ssd_chunk_state_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(
           ssd_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)dyn)) != cudaSuccess)
    return (int)err;

  ssd_chunk_state_kernel<<<dim3(H, nc, B), kThreads, dyn, s>>>(
      xb, dtf, af, bb, st, dc, S, H, P, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(ntile * ntile, nc, B), kThreads, 0, s>>>(
      cbm, bb, cbf, S, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t cells = (int64_t)B * H * P * N;
  ssd_state_pass_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(st, dc,
                                            static_cast<float*>(final_state),
                                            B, nc, H, P * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_output_kernel<<<dim3(H, nc * ntile, B), kThreads, dyn, s>>>(
      xb, dtf, af, cbm, st, cbf, static_cast<float*>(y), S, H, P, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

// The tensor-core route: x, Bm, Cm contiguous and 16-byte aligned;
// L a multiple of 64 up to 256, S % L == 0, P % 8 == 0 with 8 <= P <= 64,
// N 128.
// Scratch and outputs are allocated by the caller: states (B, S/L, H, P,
// N) f32, st2 (B, S/L, H, 2, P, N) bf16, dec (B, S/L, H) f32 and cd (B,
// S/L, H, 3, L) f32 (each chunk's scan: L doubles, then L floats of dt). Returns 0, a cudaError_t, or kNoEncoder /
// kMapRefused.
int ssd_tc_launch(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, void* y, void* final_state,
                  void* states, void* st2, void* dec, void* cd, int B, int S,
                  int H, int P, int N, int L, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || H < 1 || L < 64 || L > 256 || L % 64 != 0 || S < L ||
      S % L != 0 ||
      P < 8 || P > 64 || P % 8 != 0 || N != tc::N ||
      (int64_t)B * (S / L) > 65535 || !aligned(x) || !aligned(Bm) ||
      !aligned(Cm) || !aligned(st2))
    return (int)cudaErrorInvalidValue;
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::kNoEncoder;
  const int nc = S / L;
  using u64 = cuuint64_t;
  // x (B, S, H, P): boxes of one head's 64 rows x 64 columns
  const u64 xd[4] = {(u64)P, (u64)H, (u64)S, (u64)B};
  const u64 xs[3] = {(u64)P * 2, (u64)H * P * 2, (u64)S * H * P * 2};
  const cuuint32_t xbox[4] = {64, 1, 64, 1};
  // Bm, Cm (B, S, N): 64 rows x 64 columns
  const u64 bd[3] = {(u64)N, (u64)S, (u64)B};
  const u64 bs[2] = {(u64)N * 2, (u64)S * N * 2};
  const cuuint32_t bbox[3] = {64, 64, 1};
  // st2 as (B nc H 2, P, N): one half's 64 rows (p) x 64 columns (n)
  const u64 sd[3] = {(u64)N, (u64)P, (u64)2 * B * nc * H};
  const u64 ss[2] = {(u64)N * 2, (u64)P * N * 2};
  CUtensorMap mx, mb, mc, mst;
  if (!hopper::encode_bf16_sw128(fn, &mx, x, 4, xd, xs, xbox) ||
      !hopper::encode_bf16_sw128(fn, &mb, Bm, 3, bd, bs, bbox) ||
      !hopper::encode_bf16_sw128(fn, &mc, Cm, 3, bd, bs, bbox) ||
      !hopper::encode_bf16_sw128(fn, &mst, st2, 3, sd, ss, bbox))
    return hopper::kMapRefused;
  const auto* dtf = static_cast<const float*>(dt);
  const auto* af = static_cast<const float*>(A);
  auto* yf = static_cast<float*>(y);
  auto* ff = static_cast<float*>(final_state);
  auto* sf = static_cast<float*>(states);
  auto* s2 = static_cast<__nv_bfloat16*>(st2);
  auto* df = static_cast<float*>(dec);
  auto* cf = static_cast<float*>(cd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)tc::launch(mx, mb, mc, mst, dtf, af, yf, ff, sf, s2, df, cf, B,
                         S, H, P, L, s);
}

const char* ssd_error_string(int err) {
  if (err == hopper::kNoEncoder)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == hopper::kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
