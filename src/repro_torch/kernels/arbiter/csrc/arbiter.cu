// Hand-written Hopper kernels for the simulator's per-slot arbitration.
//
// They replace the two Pallas TPU kernels of the JAX package,
// src/repro/kernels/arbiter/kernel.py:
//   priority_arbiter_kernel  <- priority_arbiter (_arb_kernel)
//   srpt_topk_kernel         <- srpt_topk (_topk_kernel)
//
// Both are integer row reductions: one thread block per row, each thread
// scanning a strided set of columns, then a warp-shuffle and shared-memory
// reduction across the block. Neither keeps the TPU's (8, 128) tiles or
// its padding: ragged widths are handled by the loop bound.
//
// What bounds them on an H100: the bytes each row reads (prio + seq + elig
// = 9 B per ring slot; 4 B per key and round for the top-K) against the
// 3.35 TB/s of HBM, and at the simulator's widths (144 rows of 512-8000
// columns) the launch latency more than either.
//
// Built by build.py with nvcc for sm_90a into a shared library with a
// plain C interface; kernel.py calls it through ctypes on PyTorch's
// current stream. Every launcher returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;      // empty-slot prio/seq; "no winner" prio
constexpr int kNeg = -(1 << 30);   // missing top-K key
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Lexicographic (prio, seq, col) order: smaller wins, ties to the lowest
// column. The three fields are compared one by one: prio and seq each
// reach 2**30, so they do not pack into one 64-bit key with the column.
__device__ __forceinline__ bool arb_better(int p, int s, int c,
                                           int bp, int bs, int bc) {
  return p < bp || (p == bp && (s < bs || (s == bs && c < bc)));
}

__device__ __forceinline__ void arb_warp_reduce(int& bp, int& bs, int& bc) {
  for (int off = 16; off > 0; off >>= 1) {
    const int op = __shfl_down_sync(kFull, bp, off);
    const int os = __shfl_down_sync(kFull, bs, off);
    const int oc = __shfl_down_sync(kFull, bc, off);
    if (arb_better(op, os, oc, bp, bs, bc)) {
      bp = op;
      bs = os;
      bc = oc;
    }
  }
}

// Per row: the eligible entry with the smallest (prio, seq), ties to the
// lowest column. Ineligible entries count as (BIG, BIG), so a row with no
// eligible entry yields (BIG, 0) like the reference.
__global__ void __launch_bounds__(kThreads)
priority_arbiter_kernel(const int* __restrict__ prio,
                        const int* __restrict__ seq,
                        const bool* __restrict__ elig,
                        int* __restrict__ best_prio,
                        int* __restrict__ best_idx, int cap) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * cap;
  int bp = kBig, bs = kBig, bc = INT_MAX;
  for (int c = threadIdx.x; c < cap; c += kThreads) {
    const bool e = elig[base + c];
    const int p = e ? prio[base + c] : kBig;
    const int s = e ? seq[base + c] : kBig;
    if (arb_better(p, s, c, bp, bs, bc)) {
      bp = p;
      bs = s;
      bc = c;
    }
  }
  arb_warp_reduce(bp, bs, bc);

  __shared__ int sp[kWarps], ss[kWarps], sc[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sp[warp] = bp;
    ss[warp] = bs;
    sc[warp] = bc;
  }
  __syncthreads();
  if (warp == 0) {
    bp = lane < kWarps ? sp[lane] : kBig;
    bs = lane < kWarps ? ss[lane] : kBig;
    bc = lane < kWarps ? sc[lane] : INT_MAX;
    arb_warp_reduce(bp, bs, bc);
    if (lane == 0) {
      best_prio[row] = bp;
      best_idx[row] = bc == INT_MAX ? 0 : bc;   // cap == 0: no column
    }
  }
}

// (key descending, column ascending): larger key wins, ties to the lowest
// column. "None" is (INT_MIN, INT_MAX), below every real entry.
__device__ __forceinline__ bool topk_better(int k, int c, int bk, int bc) {
  return k > bk || (k == bk && c < bc);
}

__device__ __forceinline__ void topk_warp_reduce(int& bk, int& bc) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_down_sync(kFull, bk, off);
    const int oc = __shfl_down_sync(kFull, bc, off);
    if (topk_better(ok, oc, bk, bc)) {
      bk = ok;
      bc = oc;
    }
  }
}

// Per row: the K largest keys in descending order with their columns, ties
// to the lowest column. Round r takes the block-wide best entry among
// those strictly after round r-1's pick in that order, so no per-thread
// top-K buffer is needed and any K works; rounds past the row's width
// write (NEG, -1). The caller normalizes (keys clamped at 0, columns -1
// where the key is not positive).
__global__ void __launch_bounds__(kThreads)
srpt_topk_kernel(const int* __restrict__ keys, int* __restrict__ vals,
                 int* __restrict__ idx, int M, int K) {
  const int row = blockIdx.x;
  const int* rk = keys + static_cast<size_t>(row) * M;
  __shared__ int sk[kWarps], sc[kWarps];
  __shared__ int pick_k, pick_c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int pk = INT_MAX, pc = -1;   // round 0: every entry is after the "pick"
  for (int r = 0; r < K; ++r) {
    int bk = INT_MIN, bc = INT_MAX;
    for (int c = threadIdx.x; c < M; c += kThreads) {
      const int k = rk[c];
      const bool after = r == 0 || k < pk || (k == pk && c > pc);
      if (after && topk_better(k, c, bk, bc)) {
        bk = k;
        bc = c;
      }
    }
    topk_warp_reduce(bk, bc);
    if (lane == 0) {
      sk[warp] = bk;
      sc[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
      bk = lane < kWarps ? sk[lane] : INT_MIN;
      bc = lane < kWarps ? sc[lane] : INT_MAX;
      topk_warp_reduce(bk, bc);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(row) * K + r;
        const bool none = bc == INT_MAX;
        vals[o] = none ? kNeg : bk;
        idx[o] = none ? -1 : bc;
        pick_k = bk;
        pick_c = bc;
      }
    }
    __syncthreads();
    // once the row is exhausted the pick is (INT_MIN, INT_MAX), after
    // which no entry lies, so every later round writes (NEG, -1)
    pk = pick_k;
    pc = pick_c;
  }
}

}  // namespace

extern "C" {

int arbiter_priority_launch(const void* prio, const void* seq,
                            const void* elig, void* best_prio,
                            void* best_idx, int H, int cap, void* stream) {
  if (H > 0) {
    priority_arbiter_kernel<<<H, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(prio), static_cast<const int*>(seq),
        static_cast<const bool*>(elig), static_cast<int*>(best_prio),
        static_cast<int*>(best_idx), cap);
  }
  return static_cast<int>(cudaGetLastError());
}

int arbiter_topk_launch(const void* keys, void* vals, void* idx, int H,
                        int M, int K, void* stream) {
  if (H > 0 && K > 0) {
    srpt_topk_kernel<<<H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<int*>(vals),
        static_cast<int*>(idx), M, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* arbiter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
