"""A plain-torch model of the CUDA ring-row routine (``arb_rows`` in
``csrc/arbiter.cu``), held bit for bit to the plain version and to the
JAX package on the CPU.

``csrc/arbiter.cu`` cannot run here, so this file models what
``arb_rows`` does, step by step, and checks that the design computes the
function before a card runs it:

* the columns each of a row's ``nt`` threads takes, in its order: with
  the row's prio, seq and elig at one offset from their 16-, 16- and
  4-byte boundaries, unit v of 4 columns (from the row's first 16-byte
  boundary of prio on) to thread ``v % nt``, the 0-3 head columns before
  the first unit and the tail columns after the last to one thread each,
  the tail after the units and the head last (winning a tie); otherwise
  column c to thread ``c % nt``;
* each thread's best entry in one packed order, prio above seq, each
  half sign-flipped, an ineligible entry packed as exactly (BIG, BIG),
  a strict compare keeping the lowest column of a tie (the kernel takes
  a thread's columns by a tree of such compares, which keeps the same
  entry, since a thread's columns ascend from its units to its tail and
  its head is below them all);
* the three hardware reductions across a warp (the key's high word, its
  low word among the lanes holding the winning high word, the column
  among the lanes holding both), then the row's first warp folding in
  the other warps' results one by one, a tie to the lower column;
* the rule for a winner whose seq is BIG or more, where the plain
  version's argmin finds BIG at columns of other prios too: column 0
  when no seq of the row exceeds BIG, else the first column that is not
  (winner's prio, seq above BIG), else the winner's column.

The model must equal ``priority_arbiter_ref`` exactly, for any int32
input, and JAX's ``ops.arbitrate(interpret=True)`` on the Pallas
kernel's contract (values in [0, BIG], a winner's seq below BIG). When
a row's winner has seq BIG (``test_seq_big_winner_follows_the_plain_
version``) the plain versions of both packages answer column 0, JAX's
Pallas kernel the first column of the block that holds the winner, and
the earlier scalar CUDA routine the winner's column. Run with
``PYTHONPATH=src python -m pytest tests/test_torch_arbiter_design.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arbiter import ops as jops
from repro.kernels.arbiter import ref as jref
from repro_torch.kernels.arbiter.ref import BIG, priority_arbiter_ref

torch.set_num_threads(1)

WARP = 32
INT_MIN, INT_MAX = -(2 ** 31), 2 ** 31 - 1
NONE = 2 ** 32 - 1                 # ~0u: a word no real lane wins with
LAYOUTS = [32, 64, 128, 256]       # threads a row (arb_rows' nt)


# ------------------------------------------------------------ the order --

def pack(p, s):
    """``arb_pack`` as its two unsigned words: (prio ^ 2**31, seq ^
    2**31), int64 tensors in [0, 2**32)."""
    return (torch.as_tensor(p).long() + 2 ** 31,
            torch.as_tensor(s).long() + 2 ** 31)


def test_packed_order_is_prio_then_seq():
    """The two sign-flipped words order every pair of int32 (prio, seq)
    as the lexicographic order does, and (BIG, BIG) packs below the
    all-ones word pair that marks a thread with no entry."""
    vals = [INT_MIN, INT_MIN + 1, -BIG, -1, 0, 1, 7, BIG - 1, BIG, BIG + 1,
            INT_MAX]
    entries = [(p, s) for p in vals for s in vals]
    hi, lo = pack([e[0] for e in entries], [e[1] for e in entries])
    by_words = [entries[i] for i in
                sorted(range(len(entries)), key=lambda i: (hi[i], lo[i]))]
    assert by_words == sorted(entries)
    bh, bl = pack(BIG, BIG)
    assert (int(bh), int(bl)) < (NONE, NONE)


# ------------------------------------------------------------ the model --

def thread_steps(cap: int, nt: int, head: int | None):
    """Per thread, the columns ``arb_rows`` takes in its order, each with
    its ``lower`` flag: ``head`` is the row's head (0-3) when it reads
    units, None for the scalar path."""
    steps = [[] for _ in range(nt)]
    if head is None:
        for c in range(cap):
            steps[c % nt].append((c, False))
        return steps
    head = min(cap, head)
    nu = (cap - head) // 4
    for v in range(nu):
        steps[v % nt] += [(head + 4 * v + i, False) for i in range(4)]
    for t, c in enumerate(range(head + 4 * nu, cap)):
        steps[t].append((c, False))            # the tail, after the units
    for t in range(head):
        steps[t].append((t, True))             # the head, last
    return steps


def thread_bests(hi, lo, steps):
    """Each thread's (high word, low word, column) after its steps, every
    thread at once (``arb_take``)."""
    nt, n = len(steps), max(len(s) for s in steps)
    bh = torch.full((nt,), NONE, dtype=torch.long)
    bl, bc = bh.clone(), bh.clone()
    for i in range(n):
        take = torch.tensor([i < len(s) for s in steps])
        col = torch.tensor([s[i][0] if i < len(s) else 0 for s in steps])
        lower = torch.tensor([i < len(s) and s[i][1] for s in steps])
        h, l_ = hi[col], lo[col]
        less = (h < bh) | ((h == bh) & (l_ < bl))
        tie = (h == bh) & (l_ == bl)
        win = take & (less | (lower & tie))
        bh, bl = torch.where(win, h, bh), torch.where(win, l_, bl)
        bc = torch.where(win, col, bc)
    return bh, bl, bc


def warp_min(bh, bl, bc):
    """``arb_warp_min`` over lanes (the last axis): three rounds of
    ``__reduce_min_sync``."""
    h = bh.amin(-1, keepdim=True)
    l_ = torch.where(bh == h, bl, NONE).amin(-1, keepdim=True)
    c = torch.where((bh == h) & (bl == l_), bc, NONE).amin(-1)
    return h[..., 0], l_[..., 0], c


def block_min(bh, bl, bc):
    """A row's threads (a multiple of 32) -> its winner: each warp by
    ``warp_min``, then the row's first warp folds in the others' results
    one by one (the warps' columns interleave, so a tie goes to the lower
    column)."""
    w = [x.reshape(-1, WARP) for x in (bh, bl, bc)]
    h, l_, c = (x.tolist() for x in warp_min(*w))
    best = (h[0], l_[0], c[0])
    for other in zip(h[1:], l_[1:], c[1:]):
        best = min(best, other)
    return best


def model_row(prio, seq, elig, nt, head):
    """One row through ``arb_rows`` -> (best_prio, best_idx)."""
    cap = prio.numel()
    p = torch.where(elig, prio, BIG).long()
    s = torch.where(elig, seq, BIG).long()
    hi, lo = pack(p, s)
    h, l_, c = block_min(*thread_bests(hi, lo, thread_steps(cap, nt, head)))
    if cap == 0:
        return BIG, 0
    pw, sw = h - 2 ** 31, l_ - 2 ** 31
    idx = c if c < cap else 0      # every entry (INT_MAX, INT_MAX)
    if sw >= BIG:
        if int(s.max()) <= BIG:
            idx = 0
        else:
            ok = ~((p == pw) & (s > BIG))
            idx = int(ok.nonzero()[0]) if bool(ok.any()) else idx
    return pw, idx


def row_head(base_ints: int, row: int, cap: int) -> int:
    """Columns before row ``row``'s first 16-byte boundary of prio, for
    a matrix whose data starts ``base_ints`` int32 past one."""
    return (-(base_ints + row * cap)) % 4


def model(prio, seq, elig, nt, base_ints=0, vec=True):
    """The routine on every row of an (R, cap) problem."""
    out = [model_row(prio[r], seq[r], elig[r], nt,
                     row_head(base_ints, r, prio.shape[1]) if vec else None)
           for r in range(prio.shape[0])]
    return (torch.tensor([o[0] for o in out], dtype=torch.int32),
            torch.tensor([o[1] for o in out], dtype=torch.int32))


# ------------------------------------------------------------ the cases --

def _rand(R, cap, seed, *, p=(0, 8), s=(0, 20_000), p_elig=0.5):
    rng = np.random.default_rng(seed)
    prio = rng.integers(*p, (R, cap)).astype(np.int32)
    seq = rng.integers(*s, (R, cap)).astype(np.int32)
    return prio, seq, rng.random((R, cap)) < p_elig


def _cases():
    """name -> (prio, seq, elig) as numpy, every one in the Pallas
    kernel's contract."""
    cases = {f"random cap {c}": _rand(5, c, c) for c in (1, 5, 33, 1024,
                                                       1027)}
    prio, seq, elig = _rand(6, 300, 1, p_elig=0.3)
    prio[:, ::7], seq[:, ::7], elig[:, ::7] = BIG, BIG, True
    prio[3], seq[3] = BIG, BIG                   # only (BIG, BIG) entries
    cases["eligible (BIG, BIG) entries"] = (prio, seq, elig)
    cases["negative values"] = _rand(6, 300, 2, p=(-(2 ** 30), 3),
                                     s=(-(2 ** 31), 3))
    prio, seq, elig = _rand(6, 1027, 3, p=(1, 8))
    for c in (31, 32, 127, 128, 255, 256, 511, 512, 1023, 1026):
        prio[:, c], seq[:, c], elig[:, c] = 0, 5, True   # one tie, many places
    cases["ties across threads and warps"] = (prio, seq, elig)
    prio, seq, elig = _rand(6, 1027, 6, p=(1, 8))
    # the lowest tied column (130) in a later warp than a higher one (600,
    # and 1025 for 256 threads a row)
    prio[:, [130, 200, 600, 1025]], seq[:, [130, 200, 600, 1025]] = 0, 5
    elig[:, [130, 200, 600, 1025]] = True
    cases["ties, the lowest in a later warp"] = (prio, seq, elig)
    prio, seq, elig = _rand(8, 1024, 4)
    elig[::2] = False
    cases["empty rows"] = (prio, seq, elig)
    cases["dense ties"] = _rand(6, 1024, 5, p=(0, 1), s=(0, 2), p_elig=0.9)
    return cases


CASES = _cases()


@pytest.mark.parametrize("nt", LAYOUTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_plain_version(name, nt):
    """Every layout's thread count, the row starting on a 16-byte
    boundary and 1, 2 and 3 ints past one, and the scalar path."""
    prio, seq, elig = (torch.from_numpy(a) for a in CASES[name])
    want = priority_arbiter_ref(prio, seq, elig)
    for base, vec in ((0, True), (1, True), (2, True), (3, True),
                      (0, False)):
        got = model(prio, seq, elig, nt, base, vec)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (base, vec)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel(name):
    """On these cases the plain version, which the model equals, is also
    the JAX package's plain version and its Pallas kernel (interpret
    mode)."""
    prio, seq, elig = CASES[name]
    tp, ti = priority_arbiter_ref(*(torch.from_numpy(a) for a in
                                    (prio, seq, elig)))
    args = tuple(jnp.asarray(a) for a in (prio, seq, elig))
    for jp, ji in (jref.priority_arbiter_ref(*args),
                   jops.arbitrate(*args, interpret=True)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("seed", range(6))
def test_three_rounds_over_any_assignment(seed):
    """The three reductions give the lexicographic (prio, seq, column)
    minimum over any assignment of columns to the lanes of any number of
    warps, each lane holding the best of its own columns, with keys
    drawn from a few values so that ties cross lanes and warps."""
    rng = np.random.default_rng(seed)
    cap, warps = 700, int(rng.integers(1, 9))
    p = torch.from_numpy(rng.integers(-2, 2, cap))
    s = torch.from_numpy(rng.choice([INT_MIN, -1, 0, BIG, INT_MAX], cap))
    hi, lo = pack(p, s)
    lane_of = rng.integers(0, warps * WARP, cap)
    steps = [[(c, False) for c in np.flatnonzero(lane_of == t)]
             for t in range(warps * WARP)]
    # a lane with no columns holds the all-ones words
    bh, bl, bc = thread_bests(hi, lo, [st or [(0, False)] for st in steps])
    empty = torch.tensor([not st for st in steps])
    h, l_, c = block_min(*(torch.where(empty, NONE, x)
                           for x in (bh, bl, bc)))
    want = min(zip(p.tolist(), s.tolist(), range(cap)))
    assert (h - 2 ** 31, l_ - 2 ** 31, c) == want


@pytest.mark.parametrize("n", [1, 4, 8, 32, 33])
def test_tree_of_compares_keeps_the_sequential_winner(n):
    """A thread's entries in ascending columns, reduced by a tree of
    ``arb_min`` (the right operand only if strictly smaller), as the
    kernel does unit by unit and across units, keep the entry that one
    strict compare a column keeps: the smallest key at its lowest
    column; keys from a few values, so that ties are many."""
    rng = np.random.default_rng(n)
    for _ in range(50):
        keys = rng.integers(0, 3, n).tolist()
        entries = list(zip(keys, range(n)))
        level = entries
        while len(level) > 1:
            level = [b if b[0] < a[0] else a
                     for a, b in zip(level[::2], level[1::2])] \
                + ([level[-1]] if len(level) % 2 else [])
        best = entries[0]
        for e in entries[1:]:
            best = e if e[0] < best[0] else best
        assert level[0] == best == min(entries)


def test_seq_big_winner_follows_the_plain_version():
    """An eligible winner (prio 0 at column 300) whose seq is BIG: the
    plain versions of both packages, and the model, answer column 0 (the
    argmin over seq finds BIG at every column); JAX's Pallas kernel the
    first column of its 256-column block that holds the winner; PR 11's
    CUDA routine, a plain lexicographic argmin, the winner's column."""
    prio = np.full((2, 512), 5, np.int32)
    seq = np.ones((2, 512), np.int32)
    elig = np.ones((2, 512), bool)
    prio[:, 300], seq[:, 300] = 0, BIG
    prio[1, 0], seq[1, 0] = 0, BIG + 3        # above BIG: out of contract
    t = [torch.from_numpy(a) for a in (prio, seq, elig)]
    want = priority_arbiter_ref(*t)
    assert want[0].tolist() == [0, 0] and want[1].tolist() == [0, 1]
    for nt in LAYOUTS:
        got = model(*t, nt)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = tuple(jnp.asarray(a) for a in (prio, seq, elig))
    ji = jref.priority_arbiter_ref(*args)[1]
    assert np.asarray(ji).tolist() == [0, 1]
    assert np.asarray(jops.arbitrate(*args, interpret=True)[1])[0] == 256
    lexi = min(zip(prio[0].tolist(), seq[0].tolist(), range(512)))
    assert lexi[2] == 300


@pytest.mark.parametrize("nt", [32, 256])
def test_seq_above_big_rows(nt):
    """Out of the Pallas kernel's contract, the model still equals the
    plain version: winners with seq above BIG (the rare second pass),
    every entry (INT_MAX, INT_MAX), seq around BIG, the full int32
    range."""
    prio, seq, elig = _rand(6, 600, 8)
    elig[:] = True
    prio[:, 400], seq[:, 400] = -1, BIG + 5
    prio[1, :50], seq[1, :50] = -1, BIG + 9        # every column before it
    prio[2, 0], seq[2, 0] = -1, BIG + 1
    prio[3], seq[3] = -1, BIG + 2                  # every column
    prio[4], seq[4] = INT_MAX, INT_MAX
    rows = [(prio, seq, elig),
            _rand(6, 70, 9, p=(0, 2), s=(BIG - 2, BIG + 3)),
            _rand(6, 70, 10, p=(INT_MIN, INT_MAX), s=(INT_MIN, INT_MAX))]
    for a in rows:
        t = [torch.from_numpy(x) for x in a]
        want = priority_arbiter_ref(*t)
        for base in (0, 3):
            got = model(*t, nt, base)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
