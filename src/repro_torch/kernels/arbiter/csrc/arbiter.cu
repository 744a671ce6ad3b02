// Hand-written Hopper kernels for the simulator's per-slot arbitration.
//
// They replace the Pallas TPU kernels of the JAX package:
//   priority_arbiter_kernel  <- kernels/arbiter/kernel.py priority_arbiter
//                               (_arb_kernel)
//   srpt_topk_kernel         <- kernels/arbiter/kernel.py srpt_topk
//                               (_topk_kernel)
//   fused_slot_kernel        <- kernels/arbiter/fused.py fused_slot and
//                               fused_slot_batch (_fused_kernel)
// and one that has no Pallas counterpart:
//   ring_insert_kernel       <- core/fabric.py ring_insert (plain PyTorch
//                               there and in the JAX package), in place
//
// All are integer row reductions. The per-row bodies are the __device__
// routines arb_rows (one or a group of ring rows per block) and topk_row
// (one top-K row per block); the staged kernels run one of them on every
// row, and the fused kernel runs all of a slot's rows in one launch. None
// keeps the TPU's (8, 128) tiles or its padding: ragged widths are
// handled by the loop bounds.
//
// What bounds them on an H100: the bytes each row reads (prio + seq + elig
// = 9 B per ring slot, 4 B per key) against the 3.35 TB/s of HBM, and at
// the simulator's widths (144 rows of 512-8000 columns) the latency of a
// launch and of one round trip to memory more than either. So every row
// is read once:
//   - topk_row reads its keys in 16-byte loads that a thread issues
//     together before it compares anything, keeps each thread's KC best
//     entries sorted in registers and merges the lists across the warp and
//     the block without reading the row again (one pass; the round-based
//     routine it replaced, kept as topk_row_rounds for a K above 8, makes
//     K passes);
//   - arb_rows reads prio, seq and elig in 16-, 16- and 4-byte units
//     that a thread issues together, keeps its best entry in one packed
//     u64 order (prio above seq) and reduces across the warp with three
//     hardware reductions (__reduce_min_sync) instead of shuffles and
//     compare chains; the earlier scalar routine, kept as
//     arb_rows_scalar for timing only, made two dependent scalar loads
//     a column and 15 shuffles a warp. At 144 rows a launch is
//     latency, not bytes: the launch of the blocks, one round trip of
//     loads, then the reductions (PERF.md);
//   - the fused kernel gives a block either one top-K row or a group of
//     ring rows of about the same bytes, so no block of the launch reads
//     much more than another.
//
// Built by build.py with nvcc for sm_90a into a shared library with a
// plain C interface; kernel.py calls it through ctypes on PyTorch's
// current stream. Every launcher returns cudaGetLastError(); none
// allocates or synchronizes.

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
constexpr int kKeyLoads = 8;       // int4 loads of keys in flight a thread

typedef unsigned long long u64;

// ------------------------------------------------------------ ring rows --

// The function (kernels/arbiter/ref.py priority_arbiter_ref): with an
// ineligible entry read as (BIG, BIG), a row's best_prio is its smallest
// prio p*, and best_idx the first column of the smallest seq among the
// entries whose prio is p*, every other entry counting as seq BIG there.
// So best_idx is the lexicographic argmin over (prio, seq), ties to the
// lowest column, unless that winner's seq s* is BIG or more: then the
// entries of other prios, and those of prio p* with seq BIG, tie with it
// at BIG, and best_idx is the first column that is not (p*, seq above
// BIG) -- column 0 when no seq of the row exceeds BIG, always so in an
// empty row, which gives (BIG, 0) -- or the winner's own column when
// every column is.
//
// One packed order for (prio, seq): each half sign-flipped, so that
// unsigned order is signed order, prio above seq; smaller wins. An
// ineligible entry packs to exactly (BIG, BIG), no larger sentinel, so
// that it ties with an eligible (BIG, BIG) as above.
__device__ __forceinline__ u64 arb_pack(int p, int s) {
  return (static_cast<u64>(static_cast<unsigned>(p) ^ 0x80000000u) << 32)
         | (static_cast<unsigned>(s) ^ 0x80000000u);
}

// A thread's best entry so far: the packed key, its column and the
// largest seq seen (is any above BIG?). A thread that holds no entry
// has the largest key and column, which win no round.
struct ArbBest {
  u64 key = ~0ull;
  unsigned col = ~0u;
  int smax = INT_MIN;
};

// Take column c. A thread's columns come in ascending order (its units,
// then its tail), so a strict < keeps the lowest of tied entries;
// `lower` marks a column below all those taken before it (the row's
// head, taken last), which wins a tie.
__device__ __forceinline__ void arb_take(ArbBest& b, int p, int s, bool e,
                                         int c, bool lower = false) {
  p = e ? p : kBig;
  s = e ? s : kBig;
  b.smax = max(b.smax, s);
  const u64 k = arb_pack(p, s);
  if (k < b.key || (lower && k == b.key)) {
    b.key = k;
    b.col = c;
  }
}

// The warp's best in every lane, by three hardware reductions: the key's
// high word, its low word among the lanes holding the winning high word,
// the column among the lanes holding both; and the largest seq.
__device__ __forceinline__ void arb_warp_min(ArbBest& b) {
  const unsigned hi = static_cast<unsigned>(b.key >> 32);
  const unsigned whi = __reduce_min_sync(kFull, hi);
  const unsigned wlo = __reduce_min_sync(
      kFull, hi == whi ? static_cast<unsigned>(b.key) : ~0u);
  const u64 w = (static_cast<u64>(whi) << 32) | wlo;
  b.col = __reduce_min_sync(kFull, b.key == w ? b.col : ~0u);
  b.key = w;
  b.smax = __reduce_max_sync(kFull, b.smax);
}

// The first column of a row whose entry is not (p, seq above BIG), or
// `none` if every column is: the rare branch of the function above
// (a seq above BIG), one warp, plain loads.
__device__ __noinline__ unsigned arb_first_not_above(
    const int* __restrict__ pr, const int* __restrict__ sr,
    const bool* __restrict__ er, int cap, int p, unsigned none) {
  unsigned first = ~0u;
  for (int c = threadIdx.x & 31; c < cap; c += 32) {
    const bool e = er[c];
    if (!(e && pr[c] == p && sr[c] > kBig)) {
      first = c;
      break;
    }
  }
  first = __reduce_min_sync(kFull, first);
  return first < static_cast<unsigned>(cap) ? first : none;
}

// Rows r0 .. r0 + g - 1 (those below R) of a ring stage, nt threads a
// row (a multiple of 32 with nt * g the block's threads, so a row has
// whole warps). Every thread of the block calls this (it may hold a
// __syncthreads). `vec`: prio, seq and elig start at the same offset
// from 16-, 16- and 4-byte boundaries (the launcher checks), so the
// columns of a row from its first 16-byte boundary of prio on are read
// as units of 4: an int4 of prio, an int4 of seq and a 4-byte word of
// elig. Unit v goes to thread v % nt, UNITS units in flight, and the
// 0-3 columns before the first unit (the head) and after the last (the
// tail) to one thread each; every load of a batch is issued before any
// compare, so the row costs one round trip to memory. Without `vec`
// every column is read as a scalar. Each warp reduces by arb_warp_min;
// then, with nt > 32, the row's first warp folds in the other warps'
// results: one after another from shared memory where nt is known at
// compile time (NT = nt, the staged kernel), by arb_warp_min again where
// it is not (NT = 0, the fused kernel's groups). Each measured faster
// where it is used (PERF.md).
template <int UNITS, int NT>
__device__ __forceinline__ void arb_rows(const int* __restrict__ prio,
                                         const int* __restrict__ seq,
                                         const bool* __restrict__ elig,
                                         int R, int cap, int r0, int g,
                                         int nt, bool vec,
                                         int* __restrict__ best_prio,
                                         int* __restrict__ best_idx) {
  __shared__ u64 sk[kWarps];
  __shared__ unsigned sc[kWarps];
  __shared__ int sm[kWarps];
  const int grp = threadIdx.x / nt, t = threadIdx.x % nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = r0 + grp;
  const size_t o = static_cast<size_t>(row) * cap;
  const int* pr = prio + o;
  const int* sr = seq + o;
  const bool* er = elig + o;
  ArbBest b;
  if (row < R && !vec) {
    for (int c = t; c < cap; c += nt) {
      arb_take(b, __ldg(pr + c), __ldg(sr + c), er[c], c);
    }
  } else if (row < R) {
    const int head = min(cap, static_cast<int>(
        ((16u - (reinterpret_cast<uintptr_t>(pr) & 15u)) & 15u) >> 2));
    const int nu = (cap - head) >> 2;
    const int tail = head + 4 * nu + t;
    int hp = 0, hs = 0, tp = 0, ts = 0;
    bool he = false, te = false;
    if (t < head) {
      hp = __ldg(pr + t);
      hs = __ldg(sr + t);
      he = er[t];
    }
    if (tail < cap) {
      tp = __ldg(pr + tail);
      ts = __ldg(sr + tail);
      te = er[tail];
    }
    const int4* p4 = reinterpret_cast<const int4*>(pr + head);
    const int4* s4 = reinterpret_cast<const int4*>(sr + head);
    const unsigned* e4 = reinterpret_cast<const unsigned*>(er + head);
    for (int v0 = t; v0 < nu; v0 += UNITS * nt) {
      int4 P[UNITS], S[UNITS];
      unsigned E[UNITS];
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int v = v0 + j * nt;
        if (v < nu) {
          P[j] = __ldg(p4 + v);
          S[j] = __ldg(s4 + v);
          E[j] = __ldg(e4 + v);
        }
      }
#pragma unroll
      for (int j = 0; j < UNITS; ++j) {
        const int v = v0 + j * nt, c = head + 4 * v;
        if (v < nu) {
          arb_take(b, P[j].x, S[j].x, E[j] & 0xffu, c);
          arb_take(b, P[j].y, S[j].y, (E[j] >> 8) & 0xffu, c + 1);
          arb_take(b, P[j].z, S[j].z, (E[j] >> 16) & 0xffu, c + 2);
          arb_take(b, P[j].w, S[j].w, E[j] >> 24, c + 3);
        }
      }
    }
    if (tail < cap) arb_take(b, tp, ts, te, tail);
    if (t < head) arb_take(b, hp, hs, he, t, true);
  }
  arb_warp_min(b);

  if (nt > 32) {   // the row's first warp folds in the row's other warps
    if (lane == 0) {
      sk[warp] = b.key;
      sc[warp] = b.col;
      sm[warp] = b.smax;
    }
    __syncthreads();
    if (t < 32) {   // every lane of the warp alike
      if (NT == 0) {
        const bool in = lane < nt / 32;
        b.key = in ? sk[warp + lane] : ~0ull;
        b.col = in ? sc[warp + lane] : ~0u;
        b.smax = in ? sm[warp + lane] : INT_MIN;
        arb_warp_min(b);
      } else {   // the warps' columns interleave: a tie to the lower
        for (int i = 1; i < nt / 32; ++i) {
          const u64 k = sk[warp + i];
          const unsigned c = sc[warp + i];
          if (k < b.key || (k == b.key && c < b.col)) {
            b.key = k;
            b.col = c;
          }
          b.smax = max(b.smax, sm[warp + i]);
        }
      }
    }
  }
  if (t < 32 && row < R) {   // the whole warp: the branch below reduces
    const int p = static_cast<int>(static_cast<unsigned>(b.key >> 32)
                                   ^ 0x80000000u);
    const int s = static_cast<int>(static_cast<unsigned>(b.key)
                                   ^ 0x80000000u);
    // a column past cap: cap 0, or every entry (INT_MAX, INT_MAX)
    unsigned idx = b.col < static_cast<unsigned>(cap) ? b.col : 0u;
    if (s >= kBig) {
      idx = b.smax > kBig ? arb_first_not_above(pr, sr, er, cap, p, idx)
                          : 0u;
    }
    if (lane == 0) {
      best_prio[row] = cap > 0 ? p : kBig;
      best_idx[row] = static_cast<int>(idx);
    }
  }
}

// The earlier row routine, one scalar column a step with (prio, seq, col)
// compared field by field: the earlier design, kept only so that
// chip_smoke.py times it beside arb_rows in one run
// (arbiter_priority_launch with nt 0, arbiter_fused_launch with
// scalar_rows). It differs from the function above when a winner's
// seq is BIG or more (it answers the winner's column).
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

__device__ __forceinline__ void arb_rows_scalar(const int* __restrict__ prio,
                                                const int* __restrict__ seq,
                                                const bool* __restrict__ elig,
                                                int R, int cap, int r0, int g,
                                                int* __restrict__ best_prio,
                                                int* __restrict__ best_idx) {
  const int nt = kThreads / g;
  const int grp = threadIdx.x / nt, t = threadIdx.x % nt;
  const int row = r0 + grp;
  int bp = kBig, bs = kBig, bc = INT_MAX;
  if (row < R) {   // ineligible entries count as (BIG, BIG)
    const size_t o = static_cast<size_t>(row) * cap;
    for (int c = t; c < cap; c += nt) {
      const bool e = elig[o + c];
      const int p = e ? prio[o + c] : kBig;
      const int s = e ? seq[o + c] : kBig;
      if (arb_better(p, s, c, bp, bs, bc)) {
        bp = p;
        bs = s;
        bc = c;
      }
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
  if (t < 32) {
    const bool in = lane < nt / 32;
    bp = in ? sp[warp + lane] : INT_MAX;
    bs = in ? ss[warp + lane] : INT_MAX;
    bc = in ? sc[warp + lane] : INT_MAX;
    arb_warp_reduce(bp, bs, bc);
    if (lane == 0 && row < R) {
      best_prio[row] = bp;
      best_idx[row] = bc == INT_MAX ? 0 : bc;   // cap == 0: no column
    }
  }
}

// ------------------------------------------------------- top-K, one pass --

// One total order over a row's entries: the key (offset so that unsigned
// order is signed order) above the column's complement, so a larger u64
// is exactly "key descending, then column ascending", whatever order the
// threads saw the columns in. Every entry packs above 0 (its low half is
// at least 2**32 - 1 - INT_MAX), so 0 marks an empty place in a list:
// below every entry, keys of NEG and INT_MIN included.
__device__ __forceinline__ u64 topk_pack(int key, int col) {
  return (static_cast<u64>(static_cast<unsigned>(key) ^ 0x80000000u) << 32)
         | static_cast<u64>(0xffffffffu - static_cast<unsigned>(col));
}

// Insert v into the list l, sorted descending, if it beats the last; the
// last falls off. All indices are static, so l stays in registers.
template <int KC>
__device__ __forceinline__ void topk_insert(u64 (&l)[KC], u64 v) {
  if (v > l[KC - 1]) {
#pragma unroll
    for (int i = KC - 1; i > 0; --i) {
      l[i] = v > l[i - 1] ? l[i - 1] : (v > l[i] ? v : l[i]);
    }
    l[0] = v > l[0] ? v : l[0];
  }
}

// Sort l descending: a bitonic sorting network, all indices static.
template <int KC>
__device__ __forceinline__ void bitonic_sort_desc(u64 (&l)[KC]) {
#pragma unroll
  for (int k = 2; k <= KC; k <<= 1) {
#pragma unroll
    for (int s = k / 2; s > 0; s >>= 1) {
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const int p = i ^ s;
        if (p > i) {
          const u64 a = l[i], b = l[p];
          const bool swap = (i & k) == 0 ? a < b : a > b;
          l[i] = swap ? b : a;
          l[p] = swap ? a : b;
        }
      }
    }
  }
}

// The warp's largest u64, from two 32-bit hardware reductions.
__device__ __forceinline__ u64 warp_max_u64(u64 v) {
  const unsigned hi =
      __reduce_max_sync(kFull, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_max_sync(
      kFull, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v)
                                                  : 0u);
  return (static_cast<u64>(hi) << 32) | lo;
}

// The K best of the lanes' sorted lists: K rounds, each taking the warp
// max of the lists' heads and popping it from its lane (entries are
// unique, so one lane pops). Lane r returns round r's entry.
template <int KC>
__device__ __forceinline__ u64 warp_topk(u64 (&l)[KC], int K) {
  const int lane = threadIdx.x & 31;
  u64 mine = 0;
#pragma unroll 1
  for (int r = 0; r < K; ++r) {
    const u64 m = warp_max_u64(l[0]);
    mine = lane == r ? m : mine;
    if (l[0] == m) {
#pragma unroll
      for (int i = 0; i < KC - 1; ++i) l[i] = l[i + 1];
      l[KC - 1] = 0;
    }
  }
  return mine;
}

// One row of M keys, run by a whole block: the K <= KC largest keys in
// descending order with their columns, ties to the lowest column. A row
// narrower than K (K > M) is first padded, as by the plain version, with
// K - M entries of key NEG at columns M .. K - 1, which are reported with
// column -1: they come after the row's keys of NEG and before its keys
// below NEG. The caller normalizes (keys clamped at 0, columns -1 where
// the key is not positive).
//
// Every key is read once. Between the row's first 16-byte boundary (the
// row pitch need not be a multiple of 16 B) and its last whole int4, int4
// v (columns head + 4v .. head + 4v + 3) goes to thread v % kThreads,
// kKeyLoads loads in flight; the few columns before and after go to one
// thread each. Each thread keeps its KC best entries sorted in registers:
// a sorting network takes its first KC keys, then a key enters
// only if it beats the thread's last. Such keys are rare in the
// simulator's rows (mostly zeros, whose later columns lose), and an
// insert in one lane would stall its warp, so a passing key goes to a
// queue of 32 in shared memory instead, which the warp empties into its
// lanes' lists, one key a lane, when it fills and at the end. Then
// warp_topk takes each warp's K best and, from those, warp 0 the block's.
// The padding's K - M entries go to one thread each, after the tail.
template <int KC>
__device__ __forceinline__ void topk_row(const int* __restrict__ rk, int M,
                                         int K, int* __restrict__ vals,
                                         int* __restrict__ idx) {
  static_assert(KC >= 8 && (KC & (KC - 1)) == 0 && KC / 4 <= kKeyLoads,
                "KC: a power of two from 8 to a warp");
  __shared__ u64 queue[kWarps][32];
  __shared__ u64 best[kWarps][KC];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  u64 l[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) l[i] = 0;

  int queued = 0;   // keys in the warp's queue, the same in every lane
  auto drain = [&]() {
    __syncwarp();
    if (lane < queued) topk_insert(l, queue[warp][lane]);
    queued = 0;
    __syncwarp();
  };
  auto offer = [&](u64 v) {   // every lane of the warp calls it
    const bool pass = v > l[KC - 1];
    const unsigned m = __ballot_sync(kFull, pass);
    if (m) {
      const int n = __popc(m);
      if (queued + n > 32) drain();
      if (pass) queue[warp][queued + __popc(m & ((1u << lane) - 1u))] = v;
      queued += n;
    }
  };

  const int head = min(M, static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(rk) & 15u)) & 15u) >> 2));
  const int nv = (M - head) >> 2;
  const int4* r4 = reinterpret_cast<const int4*>(rk + head);
  bool first = true;
  // b0 is the warp's first int4, so every lane runs the same iterations
  for (int b0 = t & ~31; b0 < nv; b0 += kKeyLoads * kThreads) {
    int4 x[kKeyLoads];
#pragma unroll
    for (int j = 0; j < kKeyLoads; ++j) {
      const int v = b0 + lane + j * kThreads;
      if (v < nv) x[j] = __ldg(r4 + v);
    }
    // int4 j's four entries, "none" past the row
    auto packed = [&](int j, u64 (&p)[4]) {
      const int v = b0 + lane + j * kThreads, c = head + 4 * v;
      const bool ok = v < nv;
      p[0] = ok ? topk_pack(x[j].x, c) : 0;
      p[1] = ok ? topk_pack(x[j].y, c + 1) : 0;
      p[2] = ok ? topk_pack(x[j].z, c + 2) : 0;
      p[3] = ok ? topk_pack(x[j].w, c + 3) : 0;
    };
    int j0 = 0;
    if (first) {   // the first KC / 4 int4s fill the list
#pragma unroll
      for (int j = 0; j < KC / 4; ++j) {
        u64 p[4];
        packed(j, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) l[4 * j + e] = p[e];
      }
      bitonic_sort_desc(l);
      j0 = KC / 4;
    }
    first = false;
#pragma unroll
    for (int j = 0; j < kKeyLoads; ++j) {
      if (j >= j0 && b0 + j * kThreads < nv) {   // the same in every lane
        u64 p[4];
        packed(j, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) offer(p[e]);
      }
    }
  }
  drain();
  if (t < head) topk_insert(l, topk_pack(__ldg(rk + t), t));
  const int tail = head + 4 * nv + t;       // at most 3 columns
  if (tail < M) topk_insert(l, topk_pack(__ldg(rk + tail), tail));
  if (M + t < K) topk_insert(l, topk_pack(kNeg, M + t));   // the padding

  u64 mine = warp_topk(l, K);
  if (lane < K) best[warp][lane] = mine;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      l[i] = lane < kWarps && i < K ? best[lane][i] : 0;
    }
    // the row and its padding hold at least K entries, so none is empty
    mine = warp_topk(l, K);
    if (lane < K) {
      const int c =
          static_cast<int>(0xffffffffu - static_cast<unsigned>(mine));
      vals[lane] =
          static_cast<int>(static_cast<unsigned>(mine >> 32) ^ 0x80000000u);
      idx[lane] = c < M ? c : -1;
    }
  }
}

// ------------------------------------------------------ top-K, K rounds --

// (key descending, column ascending): larger key wins, ties to the lowest
// column. A thread that has no entry holds (INT_MIN, INT_MAX), below every
// entry.
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

// The same function for any K (a K above the largest KC): round r takes
// the block-wide best entry among those strictly after round r-1's pick
// in that order, re-reading the row each round, so no per-thread list is
// needed. The padding of a row narrower than K is read as keys of NEG at
// columns M .. K - 1, as in topk_row.
__device__ __forceinline__ void topk_row_rounds(const int* __restrict__ rk,
                                                int M, int K,
                                                int* __restrict__ vals,
                                                int* __restrict__ idx) {
  __shared__ int sk[kWarps], sc[kWarps];
  __shared__ int pick_k, pick_c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int pk = INT_MAX, pc = -1;   // round 0: every entry is after the "pick"
  for (int r = 0; r < K; ++r) {
    int bk = INT_MIN, bc = INT_MAX;
    for (int c = threadIdx.x; c < max(M, K); c += kThreads) {
      const int k = c < M ? rk[c] : kNeg;
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
      if (lane == 0) {   // max(M, K) entries: round r always finds one
        vals[r] = bk;
        idx[r] = bc < M ? bc : -1;
        pick_k = bk;
        pick_c = bc;
      }
    }
    __syncthreads();
    pk = pick_k;
    pc = pick_c;
  }
}

// KC > 0: the one-pass routine for K <= KC; KC == 0: the rounds routine.
template <int KC>
__device__ __forceinline__ void topk_any(const int* __restrict__ rk, int M,
                                         int K, int* __restrict__ vals,
                                         int* __restrict__ idx) {
  if constexpr (KC == 0) {
    topk_row_rounds(rk, M, K, vals, idx);
  } else {
    topk_row<KC>(rk, M, K, vals, idx);
  }
}

// -------------------------------------------------------------- kernels --

// NT threads a row, G rows a block; UNITS = 256 / NT units of 4 columns
// in flight a thread, so that a row of up to 1024 columns is one batch.
// The wrapper launches it at 64 x 2 (kernel.py ARB_LAYOUT).
template <int NT, int G>
__global__ void __launch_bounds__(NT * G)
priority_arbiter_kernel(const int* __restrict__ prio,
                        const int* __restrict__ seq,
                        const bool* __restrict__ elig,
                        int* __restrict__ best_prio,
                        int* __restrict__ best_idx, int H, int cap,
                        bool vec) {
  arb_rows<256 / NT, NT>(prio, seq, elig, H, cap, blockIdx.x * G, G, NT,
                         vec, best_prio, best_idx);
}

// The earlier kernel (one block of 256 threads a row), timed only.
__global__ void __launch_bounds__(kThreads)
priority_arbiter_scalar_kernel(const int* __restrict__ prio,
                               const int* __restrict__ seq,
                               const bool* __restrict__ elig,
                               int* __restrict__ best_prio,
                               int* __restrict__ best_idx, int H, int cap) {
  arb_rows_scalar(prio, seq, elig, H, cap, blockIdx.x, 1, best_prio,
                  best_idx);
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
srpt_topk_kernel(const int* __restrict__ keys, int* __restrict__ vals,
                 int* __restrict__ idx, int M, int K) {
  const size_t row = blockIdx.x;
  topk_any<KC>(keys + row * M, M, K, vals + row * K, idx + row * K);
}

// One slot's stages for B runs. A stage is absent when its row count is 0
// (its pointers are then null and never read). Every array carries a
// leading run axis of length B, contiguous: run b's down rings start at
// b * H * cap, and so on. gd / gu ring rows share a block, nd / nu blocks
// of a run cover the down / up rows (the launcher sets them).
struct FusedArgs {
  const int* d_prio;
  const int* d_seq;
  const bool* d_elig;
  int* d_best_prio;
  int* d_best_idx;
  int H, cap, gd, nd;
  bool dvec;
  const int* u_prio;
  const int* u_seq;
  const bool* u_elig;
  int* u_best_prio;
  int* u_best_idx;
  int U, ucap, gu, nu;
  bool uvec;
  const int* keys;
  int* vals;
  int* idx;
  int H2, M, K;
};

// Grid (H2 + nd + nu, B): blockIdx.y is the run; blockIdx.x walks one
// block per top-K row, then nd blocks of gd down rows each, then nu blocks
// of gu up rows. The launcher picks gd and gu so that a group of ring
// rows reads about as many bytes as the launch's widest row (a top-K row
// of 4 M bytes on the main path), so the blocks of the launch read alike.
// The top-K blocks, which also compute the most, come first, so that the
// scheduler spreads them over the SMs before it doubles any up. The whole
// grid is one launch, whatever B is.
//
// The TPU version keeps every operand in VMEM at once and so needs a size
// ceiling (FUSED_VMEM_LIMIT_BYTES in the JAX package's dispatch.py) past
// which it hands the stages to the staged kernels. Here each block reads
// its rows straight from global memory, so there is no such ceiling and
// no fallback.
//
// At most 80 registers a thread, so that 3 blocks fit on an SM: at B = 12
// the grid is several waves, and the third block hides more latency than
// the registers it costs (ptxas would take 88; at 64 it spills).
//
// Its ring rows run arb_rows (a group of rows gets 32 to 256 threads a
// row, known at run time) with 2 units in flight a thread: under the 80
// registers, more units made the whole launch slower (PERF.md).
// SCALAR_ROWS instead runs the earlier scalar routine, only so that
// chip_smoke.py can time the two in one run.
template <int KC, bool SCALAR_ROWS>
__global__ void __launch_bounds__(kThreads, 3)
fused_slot_kernel(const FusedArgs a) {
  const size_t run = blockIdx.y;
  int b = blockIdx.x;
  if (b < a.H2) {
    const size_t r = run * a.H2 + b;
    topk_any<KC>(a.keys + r * a.M, a.M, a.K, a.vals + r * a.K,
                 a.idx + r * a.K);
    return;
  }
  b -= a.H2;
  if (b < a.nd) {
    const size_t o = run * a.H * a.cap;
    if constexpr (SCALAR_ROWS) {
      arb_rows_scalar(a.d_prio + o, a.d_seq + o, a.d_elig + o, a.H, a.cap,
                      b * a.gd, a.gd, a.d_best_prio + run * a.H,
                      a.d_best_idx + run * a.H);
    } else {
      arb_rows<2, 0>(a.d_prio + o, a.d_seq + o, a.d_elig + o, a.H, a.cap,
                     b * a.gd, a.gd, kThreads / a.gd, a.dvec,
                     a.d_best_prio + run * a.H, a.d_best_idx + run * a.H);
    }
    return;
  }
  b -= a.nd;
  const size_t o = run * a.U * a.ucap;
  if constexpr (SCALAR_ROWS) {
    arb_rows_scalar(a.u_prio + o, a.u_seq + o, a.u_elig + o, a.U, a.ucap,
                    b * a.gu, a.gu, a.u_best_prio + run * a.U,
                    a.u_best_idx + run * a.U);
  } else {
    arb_rows<2, 0>(a.u_prio + o, a.u_seq + o, a.u_elig + o, a.U, a.ucap,
                   b * a.gu, a.gu, kThreads / a.gu, a.uvec,
                   a.u_best_prio + run * a.U, a.u_best_idx + run * a.U);
  }
}

// Ring rows per block: the largest power of two up to kWarps whose rows
// read at most 1.5x the bytes of the launch's widest row (`target`).
int ring_rows_per_block(long long row_bytes, long long target) {
  int g = 1;
  while (g < kWarps && 4LL * g * row_bytes <= 3LL * target) g <<= 1;
  return g;
}

template <int KC>
void launch_topk(int H, const int* keys, int* vals, int* idx, int M, int K,
                 cudaStream_t stream) {
  srpt_topk_kernel<KC><<<H, kThreads, 0, stream>>>(keys, vals, idx, M, K);
}

template <int KC, bool SCALAR_ROWS>
void launch_fused(dim3 grid, const FusedArgs& a, cudaStream_t stream) {
  fused_slot_kernel<KC, SCALAR_ROWS><<<grid, kThreads, 0, stream>>>(a);
}

// Whether arb_rows may read a ring stage in units of 4 columns: prio,
// seq and elig at the same offset from 16-, 16- and 4-byte boundaries
// (then so is every row, and every run of a batch).
bool ring_vec_ok(const void* prio, const void* seq, const void* elig) {
  const auto p = reinterpret_cast<uintptr_t>(prio);
  const auto s = reinterpret_cast<uintptr_t>(seq);
  const auto e = reinterpret_cast<uintptr_t>(elig);
  return p % 4 == 0 && (s - p) % 16 == 0 && (e - p / 4) % 4 == 0;
}

// Launch the staged kernel at a layout; nt 0 launches the earlier scalar
// kernel.
int launch_priority(const void* prio, const void* seq, const void* elig,
                    void* best_prio, void* best_idx, int H, int cap,
                    int nt, int g, cudaStream_t stream) {
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  const auto p = static_cast<const int*>(prio);
  const auto s = static_cast<const int*>(seq);
  const auto e = static_cast<const bool*>(elig);
  const auto bp = static_cast<int*>(best_prio);
  const auto bi = static_cast<int*>(best_idx);
  const bool vec = ring_vec_ok(prio, seq, elig);
  const int blocks = g > 0 ? (H + g - 1) / g : 0;
  if (nt == 0) {
    priority_arbiter_scalar_kernel<<<H, kThreads, 0, stream>>>(p, s, e, bp,
                                                               bi, H, cap);
  } else if (nt == 256 && g == 1) {
    priority_arbiter_kernel<256, 1><<<blocks, 256, 0, stream>>>(
        p, s, e, bp, bi, H, cap, vec);
  } else if (nt == 128 && g == 1) {
    priority_arbiter_kernel<128, 1><<<blocks, 128, 0, stream>>>(
        p, s, e, bp, bi, H, cap, vec);
  } else if (nt == 64 && g == 2) {
    priority_arbiter_kernel<64, 2><<<blocks, 128, 0, stream>>>(
        p, s, e, bp, bi, H, cap, vec);
  } else if (nt == 32 && g == 8) {
    priority_arbiter_kernel<32, 8><<<blocks, 256, 0, stream>>>(
        p, s, e, bp, bi, H, cap, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The top-K instance for a K cap: 8 runs the one-pass routine (K <= 8),
// 0 the rounds routine (any K). kernel.py picks it.
bool topk_cap_ok(int kc, int K) { return kc == 0 || (kc == 8 && K <= kc); }

// ---------------------------------------------------------- ring insert --

// The function (kernels/arbiter/ref.py ring_insert_ref): item i of run b
// goes into ring row[b, i] of that run iff ok[b, i], at the (rank + 1)-th
// free slot of the row as it was before the call, where rank counts the
// earlier ok items of the run bound for the same row; an item whose row
// has fewer free slots is dropped, and counted. The plain version copies
// the whole ring pool and takes a cumsum of every row's free flags; this
// kernel reads only the rows that items go to and writes their slots in
// place, so it moves bytes in proportion to the chunks, not to the pool.
//
// One block a run: a run's rows belong to it alone, so no hazard crosses
// blocks. Read phase: each warp takes items of its run; for item i it
// counts the rank from the items' rows in shared memory, then reads the
// row's valid bytes in 16-byte units (one a lane, 32 a pass), counts each
// unit's free flags, and finds the unit that holds the (rank + 1)-th by a
// prefix sum across the warp; a row wider than 32 units takes more passes,
// and the warp stops at the first that holds it. Then a barrier, so that
// every item has seen the row as it was before any write. Write phase:
// each thread writes an item's msg, prio, seq and valid = 1 at the slot
// found, and thread 0 the run's dropped count.
constexpr int kInsertThreads = 512;
constexpr int kUnit = 16;          // valid bytes a lane reads at once

struct InsertArgs {
  int* msg_a;                      // (B, R, cap) rings, dense
  int* prio_a;
  int* seq_a;
  unsigned char* valid_a;
  int R, cap, n;
  bool vec;                        // every row starts on a 16-byte boundary
  const int* row;                  // (B, n) items, at any strides
  const unsigned char* ok;
  const int* msg;
  const int* prio;
  const int* seq;
  long long row_s[2], ok_s[2], msg_s[2], prio_s[2], seq_s[2];
  int* dropped;                    // (B,)
};

// Bit k set where byte k of w is 0 (a free slot), for k < 4.
__device__ __forceinline__ unsigned free_bits4(unsigned w) {
  const unsigned z = __vseteq4(w, 0u);     // 0x01 in each zero byte
  return (z & 1u) | ((z >> 7) & 2u) | ((z >> 14) & 4u) | ((z >> 21) & 8u);
}

// The free flags of columns [c, c + 16) of a row as a 16-bit mask (bit k:
// column c + k); columns at or past cap are not free.
__device__ __forceinline__ unsigned free_unit(const unsigned char* v, int c,
                                              int cap, bool vec) {
  if (c >= cap) return 0u;
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(v + c);
    return free_bits4(u.x) | free_bits4(u.y) << 4 | free_bits4(u.z) << 8
           | free_bits4(u.w) << 12;
  }
  unsigned m = 0u;
  for (int k = 0; k < kUnit && c + k < cap; ++k) {
    m |= static_cast<unsigned>(v[c + k] == 0) << k;
  }
  return m;
}

// The column of the target-th (>= 1) free slot of a row, in every lane, or
// -1 if the row has fewer.
__device__ int warp_find_free(const unsigned char* v, int cap, bool vec,
                              int target, int lane) {
  for (int c0 = 0; c0 < cap; c0 += 32 * kUnit) {
    const int c = c0 + lane * kUnit;
    unsigned m = free_unit(v, c, cap, vec);
    const int f = __popc(m);
    int incl = f;                            // free slots up to my unit
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    const unsigned hit = __ballot_sync(kFull, incl >= target);
    if (hit) {
      const int src = __ffs(hit) - 1;
      int col = -1;
      if (lane == src) {
        for (int t = target - (incl - f); t > 1; --t) m &= m - 1;
        col = c + __ffs(m) - 1;
      }
      return __shfl_sync(kFull, col, src);
    }
    target -= __shfl_sync(kFull, incl, 31);
  }
  return -1;
}

__global__ void __launch_bounds__(kInsertThreads)
ring_insert_kernel(const InsertArgs a) {
  extern __shared__ int sh[];
  int* const srow = sh;            // item's row, -1 where it goes nowhere
  int* const spos = sh + a.n;      // its column, -1 where it is dropped
  __shared__ int sdrop;
  const long long b = blockIdx.x;
  const int n = a.n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = a.row[b * a.row_s[0] + i * a.row_s[1]];
    const bool ok = a.ok[b * a.ok_s[0] + i * a.ok_s[1]] != 0;
    srow[i] = ok && r >= 0 && r < a.R ? r : -1;
  }
  if (threadIdx.x == 0) sdrop = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const size_t run_row = static_cast<size_t>(b) * a.R;
  for (int i = threadIdx.x >> 5; i < n; i += nw) {
    const int r = srow[i];                   // one value in the warp
    if (r < 0) {
      if (lane == 0) spos[i] = -1;
      continue;
    }
    int rank = 0;
    for (int j0 = 0; j0 < i; j0 += 32) {
      const int j = j0 + lane;
      rank += __popc(__ballot_sync(kFull, j < i && srow[j] == r));
    }
    const int col = warp_find_free(a.valid_a + (run_row + r) * a.cap, a.cap,
                                   a.vec, rank + 1, lane);
    if (lane == 0) {
      spos[i] = col;
      if (col < 0) atomicAdd(&sdrop, 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int col = spos[i];
    if (col < 0) continue;
    const size_t o = (run_row + srow[i]) * a.cap + col;
    a.msg_a[o] = a.msg[b * a.msg_s[0] + i * a.msg_s[1]];
    a.prio_a[o] = a.prio[b * a.prio_s[0] + i * a.prio_s[1]];
    a.seq_a[o] = a.seq[b * a.seq_s[0] + i * a.seq_s[1]];
    a.valid_a[o] = 1;
  }
  if (threadIdx.x == 0) a.dropped[b] = sdrop;
}

}  // namespace

extern "C" {

// The staged kernel at a layout: nt threads a row and g rows a block,
// one of 256 x 1, 128 x 1, 64 x 2 and 32 x 8 (the wrapper launches
// kernel.py's ARB_LAYOUT; chip_smoke.py times them all), or PR 11's
// kernel for nt 0, which only chip_smoke.py launches, to time it.
int arbiter_priority_launch(const void* prio, const void* seq,
                            const void* elig, void* best_prio,
                            void* best_idx, int H, int cap, int nt, int g,
                            void* stream) {
  return launch_priority(prio, seq, elig, best_prio, best_idx, H, cap, nt,
                         g, static_cast<cudaStream_t>(stream));
}

int arbiter_topk_launch(const void* keys, void* vals, void* idx, int H,
                        int M, int K, int kc, void* stream) {
  if (!topk_cap_ok(kc, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (H > 0 && K > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto k = static_cast<const int*>(keys);
    const auto v = static_cast<int*>(vals);
    const auto i = static_cast<int*>(idx);
    if (kc == 8) {
      launch_topk<8>(H, k, v, i, M, K, s);
    } else {
      launch_topk<0>(H, k, v, i, M, K, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage pointers may be null where the stage's row count is 0. A top-K
// stage needs K >= 1 (the wrapper checks) and an instance kc that takes
// it. scalar_rows runs the ring rows on the earlier scalar routine, for
// chip_smoke.py's timing only (the wrapper passes 0).
int arbiter_fused_launch(const void* d_prio, const void* d_seq,
                         const void* d_elig, void* d_best_prio,
                         void* d_best_idx, int H, int cap,
                         const void* u_prio, const void* u_seq,
                         const void* u_elig, void* u_best_prio,
                         void* u_best_idx, int U, int ucap,
                         const void* keys, void* vals, void* idx, int H2,
                         int M, int K, int kc, int B, int scalar_rows,
                         void* stream) {
  if (H2 > 0 && !topk_cap_ok(kc, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedArgs a;
  a.d_prio = static_cast<const int*>(d_prio);
  a.d_seq = static_cast<const int*>(d_seq);
  a.d_elig = static_cast<const bool*>(d_elig);
  a.d_best_prio = static_cast<int*>(d_best_prio);
  a.d_best_idx = static_cast<int*>(d_best_idx);
  a.H = H;
  a.cap = cap;
  a.dvec = H > 0 && ring_vec_ok(d_prio, d_seq, d_elig);
  a.u_prio = static_cast<const int*>(u_prio);
  a.u_seq = static_cast<const int*>(u_seq);
  a.u_elig = static_cast<const bool*>(u_elig);
  a.u_best_prio = static_cast<int*>(u_best_prio);
  a.u_best_idx = static_cast<int*>(u_best_idx);
  a.U = U;
  a.ucap = ucap;
  a.uvec = U > 0 && ring_vec_ok(u_prio, u_seq, u_elig);
  a.keys = static_cast<const int*>(keys);
  a.vals = static_cast<int*>(vals);
  a.idx = static_cast<int*>(idx);
  a.H2 = H2;
  a.M = M;
  a.K = K;
  long long target = 0;   // the widest row's bytes
  if (H > 0) target = 9LL * cap;
  if (U > 0 && 9LL * ucap > target) target = 9LL * ucap;
  if (H2 > 0 && 4LL * M > target) target = 4LL * M;
  a.gd = ring_rows_per_block(9LL * cap, target);
  a.gu = ring_rows_per_block(9LL * ucap, target);
  a.nd = H > 0 ? (H + a.gd - 1) / a.gd : 0;
  a.nu = U > 0 ? (U + a.gu - 1) / a.gu : 0;
  const int blocks = a.nd + a.nu + H2;
  if (blocks > 0 && B > 0) {
    const dim3 grid(blocks, B);
    const auto s = static_cast<cudaStream_t>(stream);
    const bool one_pass = H2 == 0 || kc == 8;
    if (scalar_rows) {
      if (one_pass) {
        launch_fused<8, true>(grid, a, s);
      } else {
        launch_fused<0, true>(grid, a, s);
      }
    } else if (one_pass) {
      launch_fused<8, false>(grid, a, s);
    } else {
      launch_fused<0, false>(grid, a, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// ring_insert_kernel on B runs: rings (B, R, cap), dense (int32 msg, prio,
// seq; bool valid), updated in place; items (B, n) at the given (run,
// item) strides in elements (seq is often one value expanded, strides 0);
// dropped (B,) int32.
int arbiter_ring_insert_launch(void* msg_a, void* prio_a, void* seq_a,
                               void* valid_a, int B, int R, int cap,
                               const void* row, const void* ok,
                               const void* msg, const void* prio,
                               const void* seq, const long long* strides,
                               int n, void* dropped, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  InsertArgs a;
  a.msg_a = static_cast<int*>(msg_a);
  a.prio_a = static_cast<int*>(prio_a);
  a.seq_a = static_cast<int*>(seq_a);
  a.valid_a = static_cast<unsigned char*>(valid_a);
  a.R = R;
  a.cap = cap;
  a.n = n;
  a.vec = cap % kUnit == 0 && reinterpret_cast<uintptr_t>(valid_a) % 16 == 0;
  a.row = static_cast<const int*>(row);
  a.ok = static_cast<const unsigned char*>(ok);
  a.msg = static_cast<const int*>(msg);
  a.prio = static_cast<const int*>(prio);
  a.seq = static_cast<const int*>(seq);
  long long* const s[5] = {a.row_s, a.ok_s, a.msg_s, a.prio_s, a.seq_s};
  for (int k = 0; k < 5; ++k) {
    s[k][0] = strides[2 * k];
    s[k][1] = strides[2 * k + 1];
  }
  a.dropped = static_cast<int*>(dropped);
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ring_insert_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  ring_insert_kernel<<<B, kInsertThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* arbiter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
