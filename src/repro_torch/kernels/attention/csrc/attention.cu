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
// with every product, sum and exponential in fp32. A row with no valid
// key averages v over all Skv keys, as attention_ref does (its masked
// scores are all equal); keys past Skv do not exist and weigh 0.
//
// Design (a first version, on fp32 CUDA cores; no wgmma, no TMA): one
// block of 256 threads per (64-row q tile, head, batch), heaviest causal
// tiles launched first. The q tile sits in shared memory as fp32; a loop
// over 64-key tiles loads K and V (converted to fp32), forms the 64 x 64
// scores in registers (4 x 4 per thread), updates the running max m and
// sum l of each row, writes p over the K tile's buffer and adds p . V to
// the fp32 accumulator in registers (4 rows x 8 columns per thread). The
// loop stops after the diagonal tile when causal and after kv_len (as
// the TPU kernel skips blocks above the diagonal); it goes on through
// the remaining tiles only while a row of the tile has seen no valid
// key, so such a row averages all keys, as attention_ref does. At the
// end o = acc / max(l, 1e-30). The accurate expf is used (no fast math):
// the kernel is held to attention_ref within 2e-5 on fp32 inputs.
//
// Masked scores are the finite NEG_INF, never -inf: a row whose first
// tiles are all masked gets p = exp(0) = 1 there until a valid key
// arrives, and then corr = exp(NEG_INF - m) = 0 wipes them out, exactly
// as in the TPU kernel. Only keys past Skv get -inf (p = 0, never NaN,
// since m starts at NEG_INF).
//
// Bound at Llama-3.2-3B's prefill shape (B 4, S 4096, H 24, KV 8, d 128,
// causal, bf16): 206.2 GFLOP of q.k and 206.2 GFLOP of p.v over the
// causal half, against 268.4 MB of operands (0.080 ms by bytes). q.k of
// bf16 operands is exact on the bf16 tensor cores (989 TFLOP/s, 0.208
// ms); p.v with fp32 p needs the fp32 CUDA cores (67 TFLOP/s, 3.08 ms).
// So the function's bound is 3.08 ms. This design runs both products on
// the CUDA cores, which alone takes 6.16 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int SP = BK + 4;       // row stride of the p tile (floats)
constexpr int kMaxD = 128;
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
// 64 jj + 4 tx + e (jj < 2, e < 4). The 16 threads of a row are one half
// of a warp, so row reductions are half-warp shuffles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int H,
    int KV, int d, int dv, int causal, int has_window, int window,
    int kv_len, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dq = (d + 3) & ~3;              // q/k columns, zero-padded
  const int sq = dq + 4;                    // q/k row stride
  const int nj = dv <= 64 ? 1 : 2;          // 64-column halves of v
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

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
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
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
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
      for (int jj = 0; jj < 2; ++jj) {
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
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * jj + 4 * tx + e;
        if (col < dv) from_f(orow + col, acc[i][4 * jj + e] / li);
      }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KV, int d, int dv,
                   int causal, int has_window, int window, int kv_len,
                   float scale, cudaStream_t stream) {
  const int dq = (d + 3) & ~3, sq = dq + 4;
  const int sv = (dv <= 64 ? 64 : 128) + 4;
  const size_t k_floats = (size_t)(BK * sq > BQ * SP ? BK * sq : BQ * SP);
  const size_t smem = ((size_t)BQ * sq + k_floats + (size_t)BK * sv) *
                      sizeof(float);
  const uintptr_t align = 4 * sizeof(T);
  const int vec = d % 4 == 0 && dv % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(q) % align) == 0 &&
                  (reinterpret_cast<uintptr_t>(k) % align) == 0 &&
                  (reinterpret_cast<uintptr_t>(v) % align) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, d, dv,
      causal, has_window, window, kv_len, scale, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (q, k, v and o all of it). All tensors
// contiguous; 1 <= d, dv <= 128; H % KV == 0. Returns a cudaError_t.
int attention_launch(const void* q, const void* k, const void* v, void* o,
                     int dtype, int B, int Sq, int Skv, int H, int KV, int d,
                     int dv, int causal, int has_window, int window,
                     int kv_len, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || d < 1 ||
      d > kMaxD || dv < 1 || dv > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, Sq, Skv, H, KV, d, dv, causal,
                              has_window, window, kv_len, scale, s);
  return (int)launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, d, dv,
                                    causal, has_window, window, kv_len, scale,
                                    s);
}

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
