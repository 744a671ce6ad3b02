// Flash attention (online softmax over K/V tiles) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py:
// flash_attention (_attn_kernel, pallas_call at :91). It computes the same
// function as the plain version kernels/attention/ref.py:attention_ref:
// for q (B,Sq,H,d), k (B,Skv,KV,d), v (B,Skv,KV,dv), bf16 or fp32, with
// the kv head of query head h at h / (H / KV),
//
//   s[i,j] = (q_i . k_j) * scale        where key j is valid for query i
//          = NEG_INF (-1e30)            where it is not
//   valid  = j < kv_len  [&& j <= i if causal]  [&& j > i - window]
//   o_i    = sum_j softmax_j(s[i,:]) v_j,  cast to q's dtype,
//
// with every product exact and every sum and exponential in fp32. A row
// with no valid key averages v over all Skv keys, as attention_ref does
// (its masked scores are all equal); keys past Skv do not exist and
// weigh 0.
//
// Two kernels compute it; the wrapper (kernel.py) picks one by a stated
// rule:
//
// * flash_attention_tc_kernel, for bf16 operands whose rows TMA can load
//   (d and dv multiples of 8, 16-byte aligned) with d <= 192 and
//   dv <= 160: both products on the bf16 tensor cores (wgmma), K and V
//   through a TMA + mbarrier ring. p is fp32; it splits exactly into
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi) (p - p_hi is exact in fp32,
//   and p_lo leaves at most 2^-17 p), so p.v = p_hi.v + p_lo.v is two
//   bf16 products with exact products and fp32 sums: the same function
//   as fp32 p.v to ~1e-6 relative, where rounding p to bf16 alone would
//   move the output ~2e-3 (a different function;
//   tests/test_torch_attention.py models both). Two designs of it: the
//   narrow one for dv <= 128 (128-key tiles; MLA's 192-wide q.k and
//   128-wide v among them) and the wide one for dv in (128, 160]
//   (StableLM's 160; below).
// * flash_attention_kernel, the first design, on the fp32 CUDA cores: for
//   fp32 inputs (held to attention_ref within 2e-5) and bf16 shapes the
//   tensor-core kernel does not take (d above 192 or dv above 160, as
//   (256, 256); d or dv not a multiple of 8).
//
// Both take d and dv up to 256, every head width of the registered
// configurations.
//
// Bound at Llama-3.2-3B's prefill shape (B 4, S 4096, H 24, KV 8, d 128,
// causal, bf16): 206.2 GFLOP of q.k and 206.2 GFLOP of p.v over the
// causal half, against 268.4 MB of operands (0.080 ms by bytes). On the
// bf16 tensor cores (989 TFLOP/s) the function is three such products,
// q.k, p_hi.v and p_lo.v: 618.6 GFLOP, 0.6255 ms. That is the bound.
//
// Tensor-core design: one block of two warpgroups per (128-row q tile,
// head, batch), heaviest causal tiles first. Each warpgroup owns 64 query
// rows. Thread 0 loads the q tile once and K and V tiles with TMA into a
// ring of two stages (128-byte swizzled 64-column panels, out-of-bounds
// rows and columns zero-filled), each guarded by a "full" mbarrier
// (transaction bytes) and an "empty" one (8 warps); it refills the stage
// of tile t-1 with tile t+1 while tile t's q.k runs. Per tile: S = Q K^T
// by wgmma from shared memory into fp32 registers; mask (only on tiles
// that need it), row max by quad shuffles, corr = exp(m - m_new),
// p = exp(s - m_new), l summed from the fp32 p; O *= corr; then
// O += p_hi V and O += p_lo V by wgmma with A from registers (the S
// accumulator's layout is the A fragment's, so p needs no shuffle) and V
// row-major in shared memory (the transpose bit). At the end
// o = O / max(l, 1e-30), rounded to bf16. The accurate expf is used (no
// fast math).
//
// The narrow design (dv <= 128): 128-key tiles, S in 64 registers, q.k
// over 4 DP k16 steps of DP = ceil(d / 64) q/k panels, p.V 64 DVP wide.
//
// The wide design (dv in (128, 160]) and why it is shaped so. Three v
// panels at 128-key tiles would take 1 KB + (3 + 2 (3 + 3)) 16 KB = 241
// KB of shared memory, past the 227 KB a block may take. So: 112-key
// tiles (S in 56 registers, p.V over 7 k16 steps), 1 KB + 48 KB of q +
// two stages of (42 + 42) KB of K and V = 217 KB; a p.V of exactly 160
// columns (wgmma n 160, O in 80 registers, where padding to 192 would
// multiply a sixth more); and q.k over exactly ceil(d / 16) k16 steps, 10
// at d 160 (the third panel's zero-filled half is not multiplied; 8 for
// d <= 128, 12 past 160). p stays in registers, as in the narrow design.
//
// Why two warpgroups and no producer warpgroup: at 384 threads ptxas
// gives no thread more than 168 registers, whatever setmaxnreg asks, and
// the instantiations whose O takes 64 registers or more spill there; at
// 256 a thread may take 255 and none spills (chip_smoke.py phase 1
// checks every instantiation).
//
// What holds it back. The two warpgroups, released by the same barriers,
// compute their softmax at the same time, and the tensor cores idle then.
// Overlapping one warpgroup's softmax with products (the FlashAttention-3
// ping-pong, with tile t+1's q.k issued beside tile t's p.v) needs S, p
// and O live at once; p kept in shared memory instead of registers would
// make room for it.
//
// Masked scores are the finite NEG_INF, never -inf: a row whose first
// tiles are all masked gets p = exp(0) = 1 there until a valid key
// arrives, and then corr = exp(NEG_INF - m) = 0 wipes them out, exactly
// as in the TPU kernel. Only keys past Skv get -inf (p = 0, never NaN,
// since m starts at NEG_INF). Which key tiles a block visits follows from
// the masks alone: the tiles up to the last valid key of its rows (from
// the first one that can hold a valid key, under a window), or every
// tile when one of its rows has no valid key at all, so that row
// averages all keys. Every warp computes that range alike; the loader
// needs no flag from the others.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int SP = BK + 4;       // row stride of the p tile (floats)
constexpr int kMaxD = 256;     // widest q/k and v rows either kernel takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Four consecutive elements of a row as floats (16-byte aligned source
// for fp32, 8-byte for bf16: the launcher checks).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// dst[r][c] = src[r * src_stride + c] as fp32 for r < rows_valid and
// c < d, 0 elsewhere, over rows < nrows and columns < width (a multiple
// of 4); dst rows are dst_stride floats apart.
template <typename T>
__device__ void load_tile(float* __restrict__ dst, int dst_stride, int width,
                          const T* __restrict__ src, int64_t src_stride,
                          int rows_valid, int nrows, int d, bool vec) {
  const int cpr = width >> 2;  // 4-column chunks per row
  for (int c = threadIdx.x; c < nrows * cpr; c += kThreads) {
    const int r = c / cpr, col = (c - r * cpr) << 2;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid && col < d) {
      const T* s = src + r * src_stride + col;
      if (vec) {  // d % 4 == 0, so the chunk lies inside the row
        val = load4(s);
      } else {
        val.x = to_f(s[0]);
        if (col + 1 < d) val.y = to_f(s[1]);
        if (col + 2 < d) val.z = to_f(s[2]);
        if (col + 3 < d) val.w = to_f(s[3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * dst_stride + col) = val;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i
// (i < 4), score columns tx + 16 j (j < 4) and output columns
// 64 jj + 4 tx + e (jj < nj, e < 4), nj = ceil(dv / 64) <= NJ. The 16
// threads of a row are one half of a warp, so row reductions are
// half-warp shuffles. NJ = 2 (dv <= 128) keeps two blocks an SM; NJ = 4
// (dv up to 256) holds 64 accumulators a thread and takes one.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, NJ <= 2 ? 2 : 1)
flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
    int KV, int d, int dv, int causal, int has_window, int window,
    int kv_len, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dq = (d + 3) & ~3;              // q/k columns, zero-padded
  const int sq = dq + 4;                    // q/k row stride
  const int nj = (dv + 63) / 64;            // 64-column panels of v
  const int sv = 64 * nj + 4;               // v row stride
  float* Qs = smem;                         // BQ x sq
  float* Ks = Qs + BQ * sq;                 // BK x sq, then p: BQ x SP
  float* Vs = Ks + max(BK * sq, BQ * SP);   // BK x sv
  float* Ps = Ks;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool vec4 = vec != 0;

  const int64_t q_stride = (int64_t)H * d;
  const int64_t k_stride = (int64_t)KV * d;
  const int64_t v_stride = (int64_t)KV * dv;
  const T* qb = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * d;
  const T* kb = k + (int64_t)b * Skv * k_stride + (int64_t)kvh * d;
  const T* vb = v + (int64_t)b * Skv * v_stride + (int64_t)kvh * dv;
  load_tile(Qs, sq, dq, qb, q_stride, min(BQ, Sq - q0), BQ, d, vec4);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  // tiles that can hold a valid key for some row of this q tile
  int kv_hi = causal ? min(Skv, q0 + BQ) : Skv;
  kv_hi = min(kv_hi, max(kv_len, 0));
  const int t_main = (kv_hi + BK - 1) / BK;
  const int n_tiles = (Skv + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    if (t >= t_main) {
      // past the valid keys: go on only for a row that has seen none
      int starved = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        starved |= (q0 + ty + 16 * i < Sq) && (m[i] == NEG_INF);
      if (!__syncthreads_or(starved)) break;
    }
    const int k0 = t * BK;
    const int rows = min(BK, Skv - k0);
    __syncthreads();  // the previous tile's p and v are consumed
    load_tile(Ks, sq, dq, kb + k0 * k_stride, k_stride, rows, BK, d, vec4);
    load_tile(Vs, sv, 64 * nj, vb + k0 * v_stride, v_stride, rows, BK, dv,
              vec4);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < dq; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * sq + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * sq + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x;
        if (kpos >= Skv) {
          x = -INFINITY;  // no such key
        } else {
          bool ok = kpos < kv_len;
          if (causal) ok = ok && kpos <= qpos;
          if (has_window) ok = ok && kpos > qpos - window;
          x = ok ? s[i][j] * scale : NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K: p goes over it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j];
    __syncthreads();

    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * SP + j);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj >= nj) break;
        const float* vr = Vs + j * sv + 64 * jj + 4 * tx;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + sv);
        const float4 v2 = *reinterpret_cast<const float4*>(vr + 2 * sv);
        const float4 v3 = *reinterpret_cast<const float4*>(vr + 3 * sv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* a = acc[i] + 4 * jj;
          a[0] = fmaf(pv[i].w, v3.x, fmaf(pv[i].z, v2.x,
                      fmaf(pv[i].y, v1.x, fmaf(pv[i].x, v0.x, a[0]))));
          a[1] = fmaf(pv[i].w, v3.y, fmaf(pv[i].z, v2.y,
                      fmaf(pv[i].y, v1.y, fmaf(pv[i].x, v0.y, a[1]))));
          a[2] = fmaf(pv[i].w, v3.z, fmaf(pv[i].z, v2.z,
                      fmaf(pv[i].y, v1.z, fmaf(pv[i].x, v0.z, a[2]))));
          a[3] = fmaf(pv[i].w, v3.w, fmaf(pv[i].z, v2.w,
                      fmaf(pv[i].y, v1.w, fmaf(pv[i].x, v0.w, a[3]))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)b * Sq + qpos) * H * dv + (int64_t)h * dv;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * jj + 4 * tx + e;
        if (col < dv) from_f(orow + col, acc[i][4 * jj + e] / li);
      }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KV, int d, int dv,
                   int causal, int has_window, int window, int kv_len,
                   float scale, cudaStream_t stream) {
  const int dq = (d + 3) & ~3, sq = dq + 4;
  const int sv = 64 * ((dv + 63) / 64) + 4;
  const size_t k_floats = (size_t)(BK * sq > BQ * SP ? BK * sq : BQ * SP);
  const size_t smem = ((size_t)BQ * sq + k_floats + (size_t)BK * sv) *
                      sizeof(float);
  const uintptr_t align = 4 * sizeof(T);
  const int vec = d % 4 == 0 && dv % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) % align) == 0 &&
                  (reinterpret_cast<uintptr_t>(k) % align) == 0 &&
                  (reinterpret_cast<uintptr_t>(v) % align) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, d, dv,
      causal, has_window, window, kv_len, scale, vec);
  return cudaGetLastError();
}


// ------------------------------------------------- tensor-core kernel ----

namespace tc {

using namespace hopper;

constexpr int BQ = 128;             // query rows per block
constexpr int STAGES = 2;           // K/V tiles in flight
constexpr int kThreads = 256;       // two warpgroups; thread 0 also loads
constexpr int PANEL = 64;           // bf16 columns in a 128-byte row
constexpr uint32_t ROW_BYTES = 128;
constexpr uint32_t TILE = BQ * ROW_BYTES;  // bytes of one 128-row panel
// Widest q/k and v rows: three 64-column q/k panels; v up to 128 on the
// narrow design, up to 160 on the wide one (see the header comment).
constexpr int kTcMaxD = 192;
constexpr int kTcMaxDv = 160;
constexpr int kNarrowMaxDv = 128;
constexpr int kNarrowBK = 128;      // keys per tile, narrow design
constexpr int kWideBK = 112;        // and wide

// The key tiles [start, end) a block visits (see the header comment), in
// tiles of BK keys. Every warp of the block computes it alike.
struct TileRange {
  int start, end;
};

template <int BK>
__device__ TileRange key_tiles(int q0, int Sq, int Skv, int causal,
                               int has_window, int window, int kv_len) {
  const int lane = threadIdx.x & 31;
  const int valid_hi = min(Skv, kv_len);
  bool starved = false;
#pragma unroll
  for (int u = 0; u < BQ / 32; ++u) {
    const int i = q0 + lane + 32 * u;
    if (i >= Sq) continue;
    const int hi = causal ? min(valid_hi, i + 1) : valid_hi;
    const int lo = has_window ? max(0, i - window + 1) : 0;
    starved |= lo >= hi;  // row i has no valid key
  }
  const int n_tiles = (Skv + BK - 1) / BK;
  if (__any_sync(0xffffffffu, starved)) return {0, n_tiles};
  const int kv_hi = min(causal ? min(Skv, q0 + BQ) : Skv, valid_hi);
  const int start = has_window ? max(0, q0 - window + 1) / BK : 0;
  return {start, (kv_hi + BK - 1) / BK};
}

// KS: k16 steps of q.k (d <= 16 KS), over DP = ceil(KS / 4) 64-column
// q/k panels; NV: columns of the p.V product (dv <= NV, a multiple of 8),
// over DVP = ceil(NV / 64) v panels; BK: keys per tile (a multiple of 16).
// The narrow design is <4 DP, 64 DVP, 128> with DP <= 3, DVP <= 2; the
// wide one <KS, 160, 112>.
template <int KS, int NV, int BK>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    int Sq, int Skv, int H, int KV, int dv, int causal, int has_window,
    int window, int kv_len, float scale) {
  constexpr int DP = (KS + 3) / 4, DVP = (NV + 63) / 64;
  constexpr uint32_t KVP = BK * ROW_BYTES;  // bytes of one K or V panel
  constexpr int NS = BK / 2;    // S registers a thread: 64 x BK / 128
  constexpr int NO = NV / 2;    // O registers a thread: 64 x NV / 128
  constexpr int PK = BK / 16;   // k16 steps of p.V
  static_assert(BK % 16 == 0 && NV % 8 == 0 && DP <= 3 && DVP <= 3,
                "tile shape");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + DP * TILE;             // stage s: + s DP KVP
  const uint32_t sV = sK + STAGES * DP * KVP;     // stage s: + s DVP KVP
  const uint32_t bars = sV + STAGES * DVP * KVP;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const TileRange tiles =
      key_tiles<BK>(q0, Sq, Skv, causal, has_window, window, kv_len);

  // thread 0 issues every load: key tile t into stage s
  auto load_kv = [&](int t, int s) {
    mbar_arrive_expect_tx(full_k(s), DP * KVP);
#pragma unroll
    for (int p = 0; p < DP; ++p)
      tma_load_4d(sK + (s * DP + p) * KVP, &tm_k, full_k(s), p * PANEL, kvh,
                  t * BK, b);
    mbar_arrive_expect_tx(full_v(s), DVP * KVP);
#pragma unroll
    for (int p = 0; p < DVP; ++p)
      tma_load_4d(sV + (s * DVP + p) * KVP, &tm_v, full_v(s), p * PANEL, kvh,
                  t * BK, b);
  };
  if (threadIdx.x == 0) {
    tma_prefetch_map(&tm_q);
    tma_prefetch_map(&tm_k);
    tma_prefetch_map(&tm_v);
    mbar_arrive_expect_tx(full_q, DP * TILE);
#pragma unroll
    for (int p = 0; p < DP; ++p)
      tma_load_4d(sQ + p * TILE, &tm_q, full_q, p * PANEL, h, q0, b);
    for (int i = 0; i < STAGES && tiles.start + i < tiles.end; ++i)
      load_kv(tiles.start + i, i);
  }

  // warpgroup c (warps 4 c .. 4 c + 3) owns rows q0 + 64 c .. + 63; in
  // the wgmma accumulator layout thread (warp w, lane 4 g + tq) holds rows
  // 16 w + g and 16 w + g + 8 of them (register j: row (j >> 1) & 1,
  // column 8 (j >> 2) + 2 tq + (j & 1))
  const int c = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int r_lo = q0 + 64 * c;
  const int row0 = r_lo + 16 * (warp & 3) + g;
  const int valid_hi = min(Skv, kv_len);

  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(full_q, 0);
  for (int t = tiles.start, i = 0; t < tiles.end; ++t, ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = t * BK;

    // S = Q K^T: 64 rows x BK keys, fp32, KS steps of k16 (step kk reads
    // the 32 bytes at (kk & 3) 32 of panel kk >> 2)
    mbar_wait(full_k(s), ph);
    __syncwarp();
    float sc[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t qa =
          sQ + (kk >> 2) * TILE + c * 64 * ROW_BYTES + (kk & 3) * 32;
      const uint32_t ka = sK + (s * DP + (kk >> 2)) * KVP + (kk & 3) * 32;
      const uint64_t dq = desc_sw128(qa, 16, 1024);
      const uint64_t dk = desc_sw128(ka, 16, 1024);
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, dq, dk, kk);
      else
        wgmma_ss_n112(sc, dq, dk, kk);
    }
    wgmma_commit();
    // while q.k runs, thread 0 refills the stage of the previous tile
    // once all eight warps are done with it
    if (threadIdx.x == 0 && i > 0 && t + STAGES - 1 < tiles.end) {
      const int sp = (i - 1) % STAGES;
      mbar_wait(empty(sp), ((i - 1) / STAGES) & 1);
      load_kv(t + STAGES - 1, sp);
    }
    wgmma_wait_all();
    fence_regs(sc);

    // mask (only where some key of the tile is invalid for some row of
    // the warpgroup), then the online-softmax update of each row
    float mx[2] = {-INFINITY, -INFINITY};
    const bool full = k0 + BK <= valid_hi &&
                      (!causal || k0 + BK - 1 <= r_lo) &&
                      (!has_window || k0 > r_lo + 63 - window);
    if (full) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[j] *= scale;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int key = k0 + 8 * (j >> 2) + 2 * tq + (j & 1);
        const int row = row0 + 8 * ((j >> 1) & 1);
        float x;
        if (key >= Skv) {
          x = -INFINITY;  // no such key
        } else {
          bool ok = key < kv_len;
          if (causal) ok = ok && key <= row;
          if (has_window) ok = ok && key > row - window;
          x = ok ? sc[j] * scale : NEG_INF;
        }
        sc[j] = x;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j] = expf(sc[j] - m[(j >> 1) & 1]);
      ps[(j >> 1) & 1] += sc[j];
    }
    // l is this thread's share of the row sum; the quad adds them at the
    // end (corr is the same across the quad)
    l[0] = l[0] * corr[0] + ps[0];
    l[1] = l[1] * corr[1] + ps[1];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j] *= corr[(j >> 1) & 1];

    // p = p_hi + p_lo, each as the bf16 A fragment of k step kk: register
    // q of step kk holds accumulator registers 8 kk + 2 q and + 1
    uint32_t phi[PK][4], plo[PK][4];
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 8 * kk + 2 * q;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[j], sc[j + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(sc[j] - hf.x, sc[j + 1] - hf.y);
        phi[kk][q] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[kk][q] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += p_hi V + p_lo V: V is [BK keys x 64 DVP] row-major (MN-major
    // for wgmma's B): 8-key groups 1024 bytes apart, panels KVP apart; an
    // NV-column product reads the first NV columns of them
    mbar_wait(full_v(s), ph);
    __syncwarp();
    const uint32_t vs = sV + s * DVP * KVP;
    wgmma_fence();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        const uint64_t dvd = desc_sw128(vs + kk * 16 * ROW_BYTES, KVP, 1024);
        if constexpr (NV == 160)
          wgmma_rs_n160(acc, half ? plo[kk] : phi[kk], dvd);
        else if constexpr (NV == 128)
          wgmma_rs_n128(acc, half ? plo[kk] : phi[kk], dvd);
        else
          wgmma_rs_n64(acc, half ? plo[kk] : phi[kk], dvd);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const float li = fmaxf(x, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow =
        o + ((int64_t)b * Sq + row) * H * dv + (int64_t)h * dv;
#pragma unroll
    for (int n8 = 0; n8 < NV / 8; ++n8) {
      const int col = 8 * n8 + 2 * tq;  // dv % 8 == 0: col + 1 < dv too
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * n8 + 2 * r] / li,
                                  acc[4 * n8 + 2 * r + 1] / li);
    }
  }
}

// A contiguous bf16 tensor (batch, seq, heads, inner) as a 4-D map whose
// box is one head's `rows` rows x 64 columns, 128-byte swizzled.
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                int inner, int heads, int seq, int batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)heads * inner * 2,
                                 (cuuint64_t)seq * heads * inner * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  return encode_bf16_sw128(fn, map, ptr, 4, dims, strides, box);
}

template <int KS, int NV, int BK>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, int B, int Sq, int Skv,
                   int H, int KV, int dv, int causal, int has_window,
                   int window, int kv_len, float scale,
                   cudaStream_t stream) {
  constexpr int DP = (KS + 3) / 4, DVP = (NV + 63) / 64;
  constexpr size_t smem = 1024 + (size_t)DP * TILE +
                          (size_t)STAGES * (DP + DVP) * BK * ROW_BYTES +
                          8 * (1 + 3 * STAGES);
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<KS, NV, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_attention_tc_kernel<KS, NV, BK><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV, dv, causal,
      has_window, window, kv_len, scale);
  return cudaGetLastError();
}

}  // namespace tc

using hopper::kMapRefused;
using hopper::kNoEncoder;

}  // namespace

extern "C" {

// The CUDA-core kernel. dtype: 0 fp32, 1 bf16 (q, k, v and o all of it).
// All tensors contiguous; 1 <= d, dv <= 256; H % KV == 0. Returns a
// cudaError_t.
int attention_launch(const void* q, const void* k, const void* v, void* o,
                     int dtype, int B, int Sq, int Skv, int H, int KV, int d,
                     int dv, int causal, int has_window, int window,
                     int kv_len, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || d < 1 ||
      d > kMaxD || dv < 1 || dv > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dv > 128;
  if (dtype == 0)
    return (int)(wide ? launch<float, 4>(q, k, v, o, B, Sq, Skv, H, KV, d, dv,
                                         causal, has_window, window, kv_len,
                                         scale, s)
                      : launch<float, 2>(q, k, v, o, B, Sq, Skv, H, KV, d, dv,
                                         causal, has_window, window, kv_len,
                                         scale, s));
  return (int)(wide ? launch<__nv_bfloat16, 4>(q, k, v, o, B, Sq, Skv, H, KV,
                                               d, dv, causal, has_window,
                                               window, kv_len, scale, s)
                    : launch<__nv_bfloat16, 2>(q, k, v, o, B, Sq, Skv, H, KV,
                                               d, dv, causal, has_window,
                                               window, kv_len, scale, s));
}

// The tensor-core kernel: bf16 q, k, v and o, contiguous, each 16-byte
// aligned; d a multiple of 8 in [8, 192], dv one in [8, 160] (kTcMaxD,
// kTcMaxDv): the narrow design up to dv 128, the wide one above;
// H % KV == 0. Returns a cudaError_t, or kNoEncoder / kMapRefused.
int attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int KV, int d, int dv,
                        int causal, int has_window, int window, int kv_len,
                        float scale, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || d < 8 ||
      d > tc::kTcMaxD || d % 8 != 0 || dv < 8 || dv > tc::kTcMaxDv ||
      dv % 8 != 0 ||
      !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return (int)cudaErrorInvalidValue;
  const tc::EncodeTiled fn = tc::encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const bool wide = dv > tc::kNarrowMaxDv;
  const int bk = wide ? tc::kWideBK : tc::kNarrowBK;
  CUtensorMap mq, mk, mv;
  if (!tc::encode_map(fn, &mq, q, d, H, Sq, B, tc::BQ) ||
      !tc::encode_map(fn, &mk, k, d, KV, Skv, B, bk) ||
      !tc::encode_map(fn, &mv, v, dv, KV, Skv, B, bk))
    return kMapRefused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_TC(KS, NV, BK)                                                 \
  return (int)tc::launch<KS, NV, BK>(mq, mk, mv, o, B, Sq, Skv, H, KV, dv, \
                                     causal, has_window, window, kv_len,   \
                                     scale, s)
  if (wide) {
    // 112-key tiles, a 160-column p.V; q.k over exactly ceil(d / 16) k16
    // steps at StableLM's d 160
    if (d > 160) ATTN_TC(12, 160, tc::kWideBK);
    if (d > 128) ATTN_TC(10, 160, tc::kWideBK);
    ATTN_TC(8, 160, tc::kWideBK);
  }
  const int dp = (d + 63) / 64, dvp = (dv + 63) / 64;
  if (dp == 3 && dvp == 2) ATTN_TC(12, 128, tc::kNarrowBK);
  if (dp == 3) ATTN_TC(12, 64, tc::kNarrowBK);
  if (dp == 2 && dvp == 2) ATTN_TC(8, 128, tc::kNarrowBK);
  if (dp == 2) ATTN_TC(8, 64, tc::kNarrowBK);
  if (dvp == 2) ATTN_TC(4, 128, tc::kNarrowBK);
  ATTN_TC(4, 64, tc::kNarrowBK);
#undef ATTN_TC
}

const char* attention_error_string(int err) {
  if (err == kNoEncoder)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
