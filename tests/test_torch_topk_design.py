"""A plain-torch model of the CUDA top-K routines, held bit for bit to the
plain version and to the JAX package on the CPU.

``csrc/arbiter.cu`` cannot run here, so this file models what its top-K
routines do, step by step, and checks that the design computes the
function before a card ever runs it:

* the one-pass routine (``topk_row<KC>``, K up to KC = 8): the columns
  each of the 256 threads reads (int4 ``v`` to thread ``v % 256``, a
  scalar column each before the row's first 16-byte boundary and after
  its last whole int4), each thread's KC best entries kept sorted in the
  packed 64-bit order (the sorting network on its first KC keys, then
  the warp's queue of passing keys and its drains, in the kernel's
  order), the padding of a row narrower than K (keys of NEG at columns
  M .. K - 1, one to a thread), and the K rounds that take each warp's K
  best and then, on warp 0, the block's;
* the rounds routine (``topk_row_rounds``, a K above 8): K passes over
  the padded row, each taking the best entry after the previous pick.

The model's results must equal ``srpt_topk_raw`` exactly, and the JAX
package's ``fused._topk_rounds`` (raw) and ``ops.topk`` (normalized, its
Pallas kernel in interpret mode). The JAX raw form reports an in-width
key of ``NEG`` or below as ``(NEG, -1)`` (its running-tops prefix wins the
tie), where the port's raw form keeps the column; normalized, the two
agree, so such rows are compared normalized. Run with ``PYTHONPATH=src
python -m pytest tests/test_torch_topk_design.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arbiter import ops as jops
from repro.kernels.arbiter.fused import _topk_rounds
from repro_torch.kernels.arbiter.kernel import TOPK_CAPS, topk_cap
from repro_torch.kernels.arbiter.ref import NEG, srpt_topk_raw, topk_normalize

torch.set_num_threads(1)

THREADS, WARP = 256, 32            # kThreads and the warp in arbiter.cu
INT_MIN, INT_MAX = -(2 ** 31), 2 ** 31 - 1
NONE = torch.iinfo(torch.int64).min


# ------------------------------------------------------------ the order --

def pack_u64(key: int, col: int) -> int:
    """``topk_pack`` of arbiter.cu, in Python integers."""
    return (((key & 0xFFFFFFFF) ^ 0x80000000) << 32) | (0xFFFFFFFF - col)


def packed(keys, cols) -> torch.Tensor:
    """The same order as int64: ``pack_u64`` with its top bit flipped,
    which is key * 2**32 + (2**32 - 1 - col). The kernel's empty list
    place, u64 0, becomes ``NONE``."""
    keys, cols = torch.as_tensor(keys), torch.as_tensor(cols)
    return keys.long() * 2 ** 32 + (2 ** 32 - 1 - cols.long())


def unpack(s: torch.Tensor, M: int):
    """int64 packed entries of a row of width M -> the raw ``(vals,
    idx)``; the padding's columns (M and above) become -1."""
    assert not bool((s == NONE).any()), "an empty place reached the output"
    col = 2 ** 32 - 1 - (s & 0xFFFFFFFF)
    return ((s >> 32).to(torch.int32),
            torch.where(col < M, col, -1).to(torch.int32))


def test_packed_order_is_key_descending_then_column_ascending():
    """The kernel's u64 packing, its int64 form here and the tie rule
    order every pair alike, and u64 0 lies below every real entry."""
    entries = [(k, c) for k in (INT_MIN, INT_MIN + 1, NEG - 1, NEG, -1, 0, 1,
                                7, 2 ** 30, INT_MAX)
               for c in (0, 1, 2, 255, 8000, INT_MAX - 1)]
    by_rule = sorted(entries, key=lambda e: (-e[0], e[1]))
    by_u64 = sorted(entries, key=lambda e: -pack_u64(*e))
    keys = torch.tensor([e[0] for e in entries], dtype=torch.int32)
    cols = torch.tensor([e[1] for e in entries], dtype=torch.int32)
    s = packed(keys, cols)
    by_i64 = [entries[i] for i in torch.argsort(s, descending=True)]
    assert by_u64 == by_rule == by_i64
    assert min(pack_u64(*e) for e in entries) > 0
    assert all(pack_u64(k, c) - 2 ** 63 == int(v)
               for (k, c), v in zip(entries, s))
    vals, idx = unpack(s, INT_MAX)
    assert vals.tolist() == keys.tolist() and idx.tolist() == cols.tolist()


# ------------------------------------------------------------ the model --

LOADS = 8                          # kKeyLoads: int4 loads in flight a thread


def insert(lists: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``topk_insert`` for every thread at once: lists ``(..., KC)``
    sorted descending, v ``(...)``; ``NONE`` never enters."""
    KC = lists.shape[-1]
    old, new = lists, lists.clone()
    for i in range(KC - 1, 0, -1):
        new[..., i] = torch.where(
            v > old[..., i - 1], old[..., i - 1],
            torch.where(v > old[..., i], v, old[..., i]))
    new[..., 0] = torch.maximum(v, old[..., 0])
    return torch.where(v[..., None] > old[..., -1:], new, old)


def bitonic_sort_desc(lists: torch.Tensor) -> torch.Tensor:
    """``bitonic_sort_desc``: the network's compare-exchanges, in order."""
    lists = lists.clone()
    KC = lists.shape[-1]
    k = 2
    while k <= KC:
        s = k // 2
        while s:
            for i in range(KC):
                p = i ^ s
                if p > i:
                    a, b = lists[..., i].clone(), lists[..., p].clone()
                    swap = a < b if not i & k else a > b
                    lists[..., i] = torch.where(swap, b, a)
                    lists[..., p] = torch.where(swap, a, b)
            s //= 2
        k *= 2
    return lists


def warp_topk(lists: torch.Tensor, K: int) -> torch.Tensor:
    """``warp_topk`` over the lane axis (dim -2) of lists ``(..., 32,
    KC)``: K rounds of the lanes' max head, popped from its lane; returns
    ``(..., 32)`` with round r's entry in lane r."""
    lists = lists.clone()
    mine = torch.full(lists.shape[:-1], NONE)
    for r in range(K):
        m = lists[..., 0].max(dim=-1).values
        mine[..., r] = m
        pop = lists[..., 0] == m[..., None]
        assert bool(((pop.sum(-1) == 1) | (m == NONE)).all()), \
            "a round popped more than one lane"
        shifted = torch.cat([lists[..., 1:], torch.full_like(lists[..., :1],
                                                             NONE)], -1)
        lists = torch.where(pop[..., None], shifted, lists)
    return mine


def _one_pass_rows(keys: torch.Tensor, K: int, KC: int, head: int):
    """``topk_row<KC>`` on rows that share their head (the ints before
    their first 16-byte boundary)."""
    R, M = keys.shape
    W = THREADS // WARP
    nv = (M - head) // 4
    s = packed(keys, torch.arange(M).expand(R, M))
    lane, warp = torch.arange(WARP), torch.arange(W)
    lists = torch.full((R, W, WARP, KC), NONE)
    queue = torch.full((R, W, WARP), NONE)
    queued = torch.zeros((R, W), dtype=torch.long)

    def drain(lists, queued, mask):
        """Lane L of each warp in ``mask`` inserts queue slot L."""
        v = torch.where(mask[..., None] & (lane < queued[..., None]), queue,
                        NONE)
        return insert(lists, v), torch.where(mask, 0, queued)

    first, it = True, 0
    while it * LOADS * THREADS < nv:       # some warp's b0 is in the row
        b0 = warp * WARP + it * LOADS * THREADS                  # (W,)
        P = []
        for j in range(LOADS):
            v = b0[:, None] + lane + j * THREADS             # (W, 32)
            cols = head + 4 * v[..., None] + torch.arange(4)  # (W, 32, 4)
            got = s[:, cols.clamp(max=M - 1)]                # (R, W, 32, 4)
            P.append(torch.where((v < nv)[..., None], got, NONE))
        j0 = 0
        if first:
            lists = bitonic_sort_desc(torch.cat(P[:KC // 4], -1))
            j0 = KC // 4
        first = False
        for j in range(j0, LOADS):
            active = (b0 + j * THREADS < nv)[None, :].expand(R, W)
            for e in range(4):
                v = P[j][..., e]
                passes = (v > lists[..., -1]) & active[..., None]
                n = passes.sum(-1)
                lists, queued = drain(lists, queued, queued + n > WARP)
                # a passing lane's slot: the queue's count plus the
                # passing lanes below it; the others write a spare slot
                pos = queued[..., None] + passes.cumsum(-1) - passes.long()
                spare = torch.cat([queue, queue[..., :1]], -1)
                spare.scatter_(-1, torch.where(passes, pos, WARP), v)
                queue = spare[..., :WARP]
                queued = queued + n
        it += 1
    lists, queued = drain(lists, queued, torch.ones_like(queued, dtype=bool))
    flat = lists.view(R, THREADS, KC)
    for c in list(range(head)) + list(range(head + 4 * nv, M)):
        t = c if c < head else c - head - 4 * nv
        flat[:, t] = insert(flat[:, t], s[:, c])
    for t in range(K - M):                  # the padding, one to a thread
        flat[:, t] = insert(flat[:, t], packed(NEG, M + t).expand(R))
    lists = flat.view(R, W, WARP, KC)
    mine = warp_topk(lists, K)                                   # (R, W, 32)
    # warp 0: lane L < 8 takes warp L's K best, the other lanes nothing
    best = torch.full((R, WARP, KC), NONE)
    best[:, :W, :K] = mine[:, :, :K]
    return unpack(warp_topk(best, K)[:, :K], M)


def one_pass_model(keys: torch.Tensor, K: int, KC: int,
                   base_mod16: int = 0):
    """``topk_row<KC>`` on every row of ``keys`` ``(H, M)`` int32, the
    matrix starting ``base_mod16`` bytes past a 16-byte boundary."""
    H, M = keys.shape
    assert K <= KC and base_mod16 in (0, 4, 8, 12)
    heads = torch.tensor([min(M, ((16 - (base_mod16 + 4 * M * r) % 16) % 16)
                              // 4) for r in range(H)])
    vals = torch.empty((H, K), dtype=torch.int32)
    idx = torch.empty((H, K), dtype=torch.int32)
    for head in heads.unique().tolist():
        rows = (heads == head).nonzero().flatten()
        vals[rows], idx[rows] = _one_pass_rows(keys[rows], K, KC, head)
    return vals, idx


def rounds_model(keys: torch.Tensor, K: int):
    """``topk_row_rounds``: round r takes the best entry of the padded row
    after round r - 1's pick."""
    H, M = keys.shape
    pad = torch.full((H, max(0, K - M)), NEG, dtype=torch.int32)
    row = torch.cat([keys, pad], 1)
    s = packed(row, torch.arange(row.shape[1]).expand_as(row))
    out, pick = [], None
    for _ in range(K):
        cand = s if pick is None else torch.where(s < pick[:, None], s, NONE)
        pick = cand.max(dim=1).values
        out.append(pick)
    return unpack(torch.stack(out, 1), M)


def kernel_model(keys: torch.Tensor, K: int, base_mod16: int = 0):
    """What a launch computes: the wrappers' route for K, then that
    routine."""
    KC = topk_cap(K)
    if KC == 0:
        return rounds_model(keys, K)
    return one_pass_model(keys, K, KC, base_mod16)


# ------------------------------------------------------------ the cases --

def _ties_across_boundaries(H=4, M=8000):
    """Equal top keys at columns that fall to different threads, warps
    and int4 batches: the lowest columns must win."""
    keys = np.zeros((H, M), np.int32)
    tied = [4 * 31 + 3, 4 * 32, 4 * 255 + 3, 4 * 256, 4 * 257 + 1,
            4 * 2048 - 4 * 256 + 2, 4000, M - 1]
    keys[:, tied] = 9
    keys[1, 0] = 9                           # a head column
    keys[2, M - 2] = 10                      # the tail beats the ties
    keys[3, tied[::2]] = 11                  # two tied levels
    return keys


def _special(H, M, seed):
    """Keys drawn from the values that sit at the order's edges."""
    rng = np.random.default_rng(seed)
    pool = np.array([INT_MIN, INT_MIN + 1, NEG - 1, NEG, NEG + 1, -1, 0, 1, 5,
                     INT_MAX], np.int64)
    return pool[rng.integers(0, len(pool), (H, M))].astype(np.int32)


def _grant(H, M, seed, p_pos=0.05, hi=1 << 30):
    """Grant-matrix-like keys: mostly 0, some positive with duplicates."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((H, M)) < p_pos, rng.integers(1, hi, (H, M)),
                    0).astype(np.int32)


CASES = {
    # name: (keys, K, base_mod16)
    "all equal 6x1000 K=7": (np.full((6, 1000), 5, np.int32), 7, 0),
    "all zero 3x8000 K=7": (np.zeros((3, 8000), np.int32), 7, 0),
    "ties across threads and warps 4x8000 K=7":
        (_ties_across_boundaries(), 7, 0),
    "ties across threads, unaligned 4x8000 K=7":
        (_ties_across_boundaries(), 7, 8),
    "NEG and INT_MIN 5x600 K=7": (_special(5, 600, 1), 7, 0),
    "NEG and INT_MIN, M<K 6x3 K=7": (_special(6, 3, 2), 7, 0),
    "M<K zeros and NEG 5x3 K=7": (np.array(
        [[5, 0, 5], [0, 0, 0], [NEG, 3, 0], [NEG, NEG, NEG], [1, 2, 3]],
        np.int32), 7, 0),
    "M=1 4x1 K=2": (_grant(4, 1, 3, p_pos=0.5), 2, 0),
    "M=1 K=1": (np.array([[7], [0], [NEG]], np.int32), 1, 0),
    "K=1 8x8000": (_grant(8, 8000, 4), 1, 0),
    "K=8, the cap 5x1000": (_grant(5, 1000, 5, p_pos=0.3, hi=4), 8, 0),
    "K=9, rounds 5x1000": (_grant(5, 1000, 6, p_pos=0.3, hi=4), 9, 0),
    "K=8 > M, keys below NEG 6x5": (_special(6, 5, 7), 8, 0),
    "K=33, rounds 4x1000": (_grant(4, 1000, 8, p_pos=0.5, hi=8), 33, 0),
    "K=40 > M, rounds 3x37": (_special(3, 37, 9), 40, 0),
    "ragged M=37 13x37 K=7, pitch 148 B": (_grant(13, 37, 10, p_pos=0.5), 7,
                                           0),
    "ragged M=37, start 4 B off 13x37 K=7": (_grant(13, 37, 11, p_pos=0.5),
                                             7, 4),
    "ragged M=37, start 12 B off 9x37 K=5": (_special(9, 37, 12), 5, 12),
    "ragged M=1000 13x1000 K=7": (_grant(13, 1000, 13, p_pos=0.3), 7, 0),
    "dense 16x8000 K=7": (_grant(16, 8000, 14, p_pos=1.0), 7, 0),
    "grant 144x8000 K=7": (_grant(144, 8000, 15), 7, 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain(name):
    keys, K, base = CASES[name]
    keys = torch.from_numpy(keys)
    got = kernel_model(keys, K, base)
    want = srpt_topk_raw(keys, K)
    assert all(g.dtype == torch.int32 for g in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jax(name):
    keys, K, base = CASES[name]
    got = kernel_model(torch.from_numpy(keys), K, base)
    jk = jnp.asarray(keys)
    raw = [np.asarray(a) for a in _topk_rounds(jk, K)]
    if keys.size and keys.min() <= NEG:
        # JAX's raw form reports these keys as (NEG, -1): compare them
        # normalized, as the callers see them
        got = topk_normalize(*got)
        raw = [np.asarray(a) for a in topk_normalize(
            *(torch.tensor(a) for a in raw))]
    np.testing.assert_array_equal(got[0].numpy(), raw[0])
    np.testing.assert_array_equal(got[1].numpy(), raw[1])
    vals, idx = topk_normalize(*kernel_model(torch.from_numpy(keys), K,
                                             base))
    jv, ji = jops.topk(jk, K, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("K,cap", [(1, 8), (7, 8), (8, 8), (9, 0),
                                   (32, 0), (33, 0), (1000, 0)])
def test_route_rule(K, cap):
    """The wrappers' rule: the smallest one-pass cap that takes K, else
    the rounds routine (0)."""
    assert TOPK_CAPS == (8,)
    assert topk_cap(K) == cap
