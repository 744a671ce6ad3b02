// Hand-written Hopper kernels for the simulator's per-slot arbitration.
//
// They replace the Pallas TPU kernels of the JAX package:
//   priority_arbiter_kernel  <- kernels/arbiter/kernel.py priority_arbiter
//                               (_arb_kernel)
//   srpt_topk_kernel         <- kernels/arbiter/kernel.py srpt_topk
//                               (_topk_kernel)
//   fused_slot_kernel        <- kernels/arbiter/fused.py fused_slot and
//                               fused_slot_batch (_fused_kernel)
//
// All are integer row reductions: one thread block per row, each thread
// scanning a strided set of columns, then a warp-shuffle and shared-memory
// reduction across the block. The per-row bodies are the __device__
// routines arb_row and topk_row; the staged kernels run one of them on
// every row, and the fused kernel runs all of a slot's rows in one launch.
// None keeps the TPU's (8, 128) tiles or its padding: ragged widths are
// handled by the loop bound.
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
#include <cstddef>
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

// One row, run by a whole block: the eligible entry with the smallest
// (prio, seq), ties to the lowest column. Ineligible entries count as
// (BIG, BIG), so a row with no eligible entry yields (BIG, 0) like the
// reference.
__device__ __forceinline__ void arb_row(const int* __restrict__ prio,
                                        const int* __restrict__ seq,
                                        const bool* __restrict__ elig,
                                        int cap, int* __restrict__ best_prio,
                                        int* __restrict__ best_idx) {
  int bp = kBig, bs = kBig, bc = INT_MAX;
  for (int c = threadIdx.x; c < cap; c += kThreads) {
    const bool e = elig[c];
    const int p = e ? prio[c] : kBig;
    const int s = e ? seq[c] : kBig;
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
      *best_prio = bp;
      *best_idx = bc == INT_MAX ? 0 : bc;   // cap == 0: no column
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

// One row of M keys, run by a whole block: the K largest keys in
// descending order with their columns, ties to the lowest column. Round r
// takes the block-wide best entry among those strictly after round r-1's
// pick in that order, so no per-thread top-K buffer is needed and any K
// works; rounds past the row's width write (NEG, -1). The caller
// normalizes (keys clamped at 0, columns -1 where the key is not
// positive).
__device__ __forceinline__ void topk_row(const int* __restrict__ rk, int M,
                                         int K, int* __restrict__ vals,
                                         int* __restrict__ idx) {
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
        const bool none = bc == INT_MAX;
        vals[r] = none ? kNeg : bk;
        idx[r] = none ? -1 : bc;
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

__global__ void __launch_bounds__(kThreads)
priority_arbiter_kernel(const int* __restrict__ prio,
                        const int* __restrict__ seq,
                        const bool* __restrict__ elig,
                        int* __restrict__ best_prio,
                        int* __restrict__ best_idx, int cap) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * cap;
  arb_row(prio + base, seq + base, elig + base, cap, best_prio + row,
          best_idx + row);
}

__global__ void __launch_bounds__(kThreads)
srpt_topk_kernel(const int* __restrict__ keys, int* __restrict__ vals,
                 int* __restrict__ idx, int M, int K) {
  const size_t row = blockIdx.x;
  topk_row(keys + row * M, M, K, vals + row * K, idx + row * K);
}

// One slot's stages for B runs. A stage is absent when its row count is 0
// (its pointers are then null and never read). Every array carries a
// leading run axis of length B, contiguous: run b's down rings start at
// b * H * cap, and so on.
struct FusedArgs {
  const int* d_prio;
  const int* d_seq;
  const bool* d_elig;
  int* d_best_prio;
  int* d_best_idx;
  int H, cap;
  const int* u_prio;
  const int* u_seq;
  const bool* u_elig;
  int* u_best_prio;
  int* u_best_idx;
  int U, ucap;
  const int* keys;
  int* vals;
  int* idx;
  int H2, M, K;
};

// Grid (H + U + H2, B): blockIdx.y is the run, blockIdx.x walks the
// concatenated rows of the present stages — H down rows, then U up rows,
// then H2 top-K rows — and each block runs the matching row routine. The
// whole grid is one launch, whatever B is.
//
// The TPU version keeps every operand in VMEM at once and so needs a size
// ceiling (FUSED_VMEM_LIMIT_BYTES in the JAX package's dispatch.py) past
// which it hands the stages to the staged kernels. Here each block reads
// its row straight from global memory, so there is no such ceiling and no
// fallback.
//
// Load balance is left as it is: a top-K row of 8000 keys and K rounds
// takes several times as long as a ring row of 512-1024 slots, and at
// B = 1 the grid (432 blocks) is one wave on 132 SMs.
__global__ void __launch_bounds__(kThreads)
fused_slot_kernel(const FusedArgs a) {
  const size_t run = blockIdx.y;
  int row = blockIdx.x;
  if (row < a.H) {
    const size_t r = run * a.H + row;
    const size_t o = r * a.cap;
    arb_row(a.d_prio + o, a.d_seq + o, a.d_elig + o, a.cap,
            a.d_best_prio + r, a.d_best_idx + r);
    return;
  }
  row -= a.H;
  if (row < a.U) {
    const size_t r = run * a.U + row;
    const size_t o = r * a.ucap;
    arb_row(a.u_prio + o, a.u_seq + o, a.u_elig + o, a.ucap,
            a.u_best_prio + r, a.u_best_idx + r);
    return;
  }
  row -= a.U;
  const size_t r = run * a.H2 + row;
  topk_row(a.keys + r * a.M, a.M, a.K, a.vals + r * a.K, a.idx + r * a.K);
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

// Stage pointers may be null where the stage's row count is 0. A top-K
// stage needs K >= 1 (the wrapper checks).
int arbiter_fused_launch(const void* d_prio, const void* d_seq,
                         const void* d_elig, void* d_best_prio,
                         void* d_best_idx, int H, int cap,
                         const void* u_prio, const void* u_seq,
                         const void* u_elig, void* u_best_prio,
                         void* u_best_idx, int U, int ucap,
                         const void* keys, void* vals, void* idx, int H2,
                         int M, int K, int B, void* stream) {
  FusedArgs a;
  a.d_prio = static_cast<const int*>(d_prio);
  a.d_seq = static_cast<const int*>(d_seq);
  a.d_elig = static_cast<const bool*>(d_elig);
  a.d_best_prio = static_cast<int*>(d_best_prio);
  a.d_best_idx = static_cast<int*>(d_best_idx);
  a.H = H;
  a.cap = cap;
  a.u_prio = static_cast<const int*>(u_prio);
  a.u_seq = static_cast<const int*>(u_seq);
  a.u_elig = static_cast<const bool*>(u_elig);
  a.u_best_prio = static_cast<int*>(u_best_prio);
  a.u_best_idx = static_cast<int*>(u_best_idx);
  a.U = U;
  a.ucap = ucap;
  a.keys = static_cast<const int*>(keys);
  a.vals = static_cast<int*>(vals);
  a.idx = static_cast<int*>(idx);
  a.H2 = H2;
  a.M = M;
  a.K = K;
  const int rows = H + U + H2;
  if (rows > 0 && B > 0) {
    fused_slot_kernel<<<dim3(rows, B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* arbiter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
