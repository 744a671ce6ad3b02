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
// (B,S,H,P) f32 and the final state (B,H,P,N) f32. All arithmetic is fp32.
//
// The TPU grid (B, H, chunks) runs the chunk axis in order with the state
// in VMEM: B*H = 96 independent programs at the model's prefill shape,
// under one wave of this card's 132 SMs. Here the chunks run in parallel
// and only a short elementwise pass is sequential over them:
//
//   1. ssd_chunk_state_kernel  block per (h, chunk, b): the chunk's scan
//      of dt*A, its decay exp(cums_L), and its own state contribution
//      sum_j w_j x_j B_j^T (P x N);
//   2. ssd_cb_kernel           block per 64x64 tile of C.B^T per (chunk, b)
//      on and below the diagonal: it does not depend on h, so it is
//      computed once and read by every head;
//   3. ssd_state_pass_kernel   thread per (b, h, p, n): walks the chunks,
//      overwriting each chunk's contribution with the state before it,
//      and writes the final state;
//   4. ssd_output_kernel       block per (h, 64-row tile of a chunk, b):
//      the intra-chunk product and the carried-state term.
//
// Bound at the model's prefill shape (B 4, S 4096, H 24, P 64, N 128,
// L 256): ~13.4 G multiply-adds (att.x, C.state and x^T.B per head and
// chunk; C.B^T per chunk), about 0.40 ms at the fp32 CUDA-core peak, far
// above the ~164 MB of operands (~49 us at 3.35 TB/s): compute-bound.
// This first version runs the products on fp32 CUDA cores from
// shared-memory tiles with register blocking (no wgmma, no TMA); the
// scratch (per-chunk states, C.B^T) adds ~200 MB of traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float ld(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Inclusive scan of dt[b, t0 + l, h] * a over l < L into cums[l], by the
// whole block; dts[l] receives dt. Ends with a barrier.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a,
                             int64_t t0, int H, int h, int L, float* cums,
                             float* dts) {
  __shared__ float warp_tot[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {
    const int l = base + tid;
    float d = 0.f;
    if (l < L) {
      d = dt[(t0 + l) * H + h];
      dts[l] = d;
    }
    float v = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kWarps ? warp_tot[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += n;
      }
      if (lane < kWarps) warp_tot[lane] = w;
    }
    __syncthreads();
    if (l < L) cums[l] = carry + (warp > 0 ? warp_tot[warp - 1] : 0.f) + v;
    carry += warp_tot[kWarps - 1];
    __syncthreads();  // warp_tot is rewritten by the next segment
  }
}

// 1. Per chunk: its decay and its contribution to the state,
//    states[b, c, h] = sum_j dt_j exp(cums_L - cums_j) x_j B_j^T  (P x N).
//    Output tiles of 64 (p) x 128 (n); each thread holds 4 x 8.
__global__ void __launch_bounds__(kThreads) ssd_chunk_state_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ states, float* __restrict__ dec, int S, int H, int P,
    int N, int L) {
  extern __shared__ float dyn[];
  float* cums = dyn;
  float* w = dyn + L;
  __shared__ float xs[32][64];
  __shared__ float bs[32][128];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  chunk_cumsum(dt, A[h], t0, H, h, L, cums, w);
  const float last = cums[L - 1];
  for (int l = threadIdx.x; l < L; l += kThreads)
    w[l] = w[l] * expf(last - cums[l]);
  if (threadIdx.x == 0) dec[((int64_t)b * nc + c) * H + h] = expf(last);
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
  float* cums = dyn;
  float* dts = dyn + L;
  __shared__ float as[64][33];
  __shared__ float vs[32][65];
  const int ntile = (L + 63) / 64;
  const int h = blockIdx.x, c = blockIdx.y / ntile, ti = blockIdx.y % ntile;
  const int b = blockIdx.z, nc = gridDim.y / ntile;
  const int64_t t0 = (int64_t)b * S + (int64_t)c * L;
  chunk_cumsum(dt, A[h], t0, H, h, L, cums, dts);
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
          v = cbc[(int64_t)i * L + j] * expf(cums[i] - cums[j]) * dts[j];
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
      const float d = expf(cums[row]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + tx + 16 * q;
        if (p < P) y[((t0 + row) * H + h) * P + p] = acc[i][q] + d * inter[i][q];
      }
    }
  }
}

}  // namespace

extern "C" {

// Runs the four kernels in order on `stream`. Scratch and outputs are
// allocated by the caller: states (B, S/L, H, P, N), dec (B, S/L, H) and
// cb (B, S/L, L, L), all f32. Returns 0 or the first launch error.
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
  const size_t dyn = 2 * (size_t)L * sizeof(float);
  cudaError_t err;

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

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
