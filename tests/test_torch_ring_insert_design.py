"""A plain-torch model of the CUDA ring insert (``ring_insert_kernel`` in
``csrc/arbiter.cu``), held bit for bit to the plain ``fabric.ring_insert``
and to the JAX package's ``repro.core.fabric.ring_insert`` on the CPU.

``csrc/arbiter.cu`` cannot run here, so this file models what the kernel
does, step by step, and checks that the design computes the function
before a card runs it:

* one block a run; an item goes somewhere only if it is ok and its row
  lies in ``[0, R)`` (the callers' not-ok items carry the sentinel row
  R); its rank is the count of earlier such items of the run bound for
  the same row, taken 32 items at a time by a ballot's popcount;
* a warp reads the target row's valid bytes in 16-byte units, one a lane
  and 32 a pass, as a 16-bit mask of free flags (four 32-bit words
  through ``__vseteq4`` where rows start on 16-byte boundaries, byte by
  byte otherwise; columns at or past cap are not free), counts each
  unit's free flags, takes an inclusive prefix sum across the warp by
  five shuffle-up steps and finds the first lane whose sum reaches
  rank + 1; that lane clears the lowest set bits of its mask until the
  one it wants is lowest; a row with fewer free slots drops the item,
  and a row wider than 32 units takes more passes;
* every item's slot is found in the read phase, against the rings as
  they were before the call, and only then (after a barrier) written:
  msg, prio, seq and valid = 1, with the run's dropped count.

Run with ``PYTHONPATH=src python -m pytest
tests/test_torch_ring_insert_design.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfabric
from repro_torch.core.fabric import ring_insert

torch.set_num_threads(1)

WARP, UNIT = 32, 16
PASS = WARP * UNIT                # columns a warp reads in one pass
CAPS = [1024, 512, 64, 100]       # 100: rows off 16-byte boundaries


# ---------------------------------------------------- the warp's steps --

def ballot(pred):
    """``__ballot_sync``: bit l set where lane l's predicate holds."""
    return sum(1 << lane for lane, p in enumerate(pred) if p)


def popc(x):
    return bin(x).count("1")


def ffs(x):
    """``__ffs``: 1 + the lowest set bit, 0 for 0."""
    return (x & -x).bit_length()


def scan_up(vals):
    """Inclusive prefix sum across the warp by ``__shfl_up_sync`` steps of
    1, 2, 4, 8 and 16 lanes, each lane adding what it read before the
    step."""
    incl = list(vals)
    for d in (1, 2, 4, 8, 16):
        incl = [v + (incl[lane - d] if lane >= d else 0)
                for lane, v in enumerate(incl)]
    return incl


def free_bits4(w):
    """``free_bits4``: ``__vseteq4(w, 0)`` (0x01 in each zero byte of a
    little-endian word) folded into bits 0-3."""
    z = sum(1 << (8 * k) for k in range(4) if (w >> (8 * k)) & 0xFF == 0)
    return (z & 1) | ((z >> 7) & 2) | ((z >> 14) & 4) | ((z >> 21) & 8)


def free_unit(vrow, c, cap, vec):
    """A lane's unit: the free flags of columns [c, c + 16) as a mask."""
    if c >= cap:
        return 0
    if vec:
        words = vrow[c:c + UNIT].view(torch.int32).tolist()
        return sum(free_bits4(w & 0xFFFFFFFF) << (4 * k)
                   for k, w in enumerate(words))
    cols = vrow[c:min(c + UNIT, cap)].tolist()
    return sum(1 << k for k, v in enumerate(cols) if v == 0)


def find_free(vrow, cap, vec, target):
    """``warp_find_free``: the column of the target-th free slot of a
    row, or -1."""
    for c0 in range(0, cap, PASS):
        m = [free_unit(vrow, c0 + lane * UNIT, cap, vec)
             for lane in range(WARP)]
        f = [popc(x) for x in m]
        incl = scan_up(f)
        hit = ballot(s >= target for s in incl)
        if hit:
            src = ffs(hit) - 1
            mm = m[src]
            for _ in range(target - (incl[src] - f[src]), 1, -1):
                mm &= mm - 1
            return c0 + src * UNIT + ffs(mm) - 1
        target -= incl[WARP - 1]
    return -1


def item_ranks(srow):
    """Each placed item's rank, by ballots over chunks of 32 earlier
    items."""
    ranks = []
    for i, r in enumerate(srow):
        rank = 0
        for j0 in range(0, i, WARP):
            rank += popc(ballot(j < i and srow[j] == r
                                for j in range(j0, j0 + WARP)))
        ranks.append(rank)
    return ranks


def kernel_model(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq,
                 *, barrier=True):
    """The kernel on B runs. Returns new rings (the kernel writes its
    arguments; the model writes copies) and the dropped counts.
    ``barrier=False`` writes each item as soon as its slot is found, in
    the warps' order, which the kernel must not do."""
    B, R, cap = valid_a.shape
    n = row.shape[1]
    out = [t.clone() for t in (msg_a, prio_a, seq_a, valid_a)]
    vec = cap % UNIT == 0
    dropped = []
    for b in range(B):
        srow = [int(r) if o and 0 <= r < R else -1
                for r, o in zip(row[b].tolist(), ok[b].tolist())]
        ranks = item_ranks(srow)
        # the read phase sees the rings as they were (with barrier=False,
        # as they are; 16 warps take items i, i + 16, ..., so the first
        # items are found first)
        seen = valid_a if barrier else out[3]
        pos = [-1] * n
        for i in range(n):
            if srow[i] >= 0:
                pos[i] = find_free(seen[b, srow[i]], cap, vec, ranks[i] + 1)
                if not barrier and pos[i] >= 0:
                    out[3][b, srow[i], pos[i]] = True
        dropped.append(sum(1 for i in range(n)
                           if srow[i] >= 0 and pos[i] < 0))
        for i in range(n):
            if pos[i] >= 0:
                at = (b, srow[i], pos[i])
                out[0][at], out[1][at] = msg[b, i], prio[b, i]
                out[2][at], out[3][at] = seq[b, i], True
    return (*out, torch.tensor(dropped, dtype=torch.int32))


# ------------------------------------------------------------ the cases --

def _inputs(B, R, cap, n, *, seed, p_valid=0.5, p_ok=0.8, rows=None,
            fills=None):
    """Random rings and items; ``rows`` limits the items' rows to a list,
    ``fills`` sets chosen rows' free slots: ``{row: free}`` (the free
    slots spread over the row). Not-ok items carry the sentinel row R."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand((B, R, cap), generator=g) < p_valid
    for r, free in (fills or {}).items():
        valid[:, r] = True
        for b in range(B):
            valid[b, r, torch.randperm(cap, generator=g)[:free]] = False
    msg_a = torch.randint(-1, 50, (B, R, cap), generator=g,
                          dtype=torch.int32)
    prio_a = torch.randint(0, 8, (B, R, cap), generator=g, dtype=torch.int32)
    seq_a = torch.randint(0, 1000, (B, R, cap), generator=g,
                          dtype=torch.int32)
    pick = torch.tensor(rows if rows is not None else list(range(R)),
                        dtype=torch.int32)
    row = pick[torch.randint(0, len(pick), (B, n), generator=g)]
    ok = torch.rand((B, n), generator=g) < p_ok
    row = torch.where(ok, row, R)
    msg = torch.randint(0, 8000, (B, n), generator=g, dtype=torch.int32)
    prio = torch.randint(0, 8, (B, n), generator=g, dtype=torch.int32)
    seq = torch.tensor(1000 + seed, dtype=torch.int32).expand(B, n)
    return msg_a, prio_a, seq_a, valid, row, ok, msg, prio, seq


def _not_ok_rows(B, R, cap, seed):
    """Not-ok items that name live rows, besides the sentinel's."""
    args = list(_inputs(B, R, cap, 40, seed=seed, p_ok=0.5))
    g = torch.Generator().manual_seed(seed + 1)
    live = torch.randint(0, R, args[4].shape, generator=g,
                         dtype=torch.int32)
    args[4] = torch.where(args[5] | (live % 2 == 0), args[4], live)
    return tuple(args)


CASES = {
    "random": lambda cap: _inputs(2, 6, cap, 24, seed=1),
    "dense": lambda cap: _inputs(2, 5, cap, 30, seed=2, p_valid=0.97,
                                 p_ok=1.0, rows=[0, 1]),
    "full_row": lambda cap: _inputs(2, 6, cap, 30, seed=3, rows=[2, 2, 4],
                                    fills={2: 0}),
    # row 1 has exactly 3 free slots and takes 4 items at most ranks 0-3
    # in some run; row 3 has exactly 2
    "exact_room": lambda cap: _inputs(3, 5, cap, 12, seed=4, p_ok=1.0,
                                      rows=[1, 3], fills={1: 3, 3: 2}),
    "one_row": lambda cap: _inputs(2, 4, cap, 40, seed=5, p_ok=1.0,
                                   rows=[0]),
    "n_above_cap": lambda cap: _inputs(1, 3, cap, cap + 9, seed=6,
                                       p_valid=0.3, p_ok=0.9, rows=[0]),
    "not_ok_and_sentinel": lambda cap: _not_ok_rows(2, 6, cap, 7),
    "runs_apart": lambda cap: _inputs(4, 3, cap, 20, seed=8, p_ok=0.9,
                                      fills={0: 1, 1: 5}),
}


def _jax(args):
    """``repro.core.fabric.ring_insert`` run by run (it has no run axis)."""
    outs = []
    for b in range(args[0].shape[0]):
        a = [jnp.asarray(t[b].numpy()) for t in args]
        outs.append([np.asarray(x) for x in jfabric.ring_insert(*a)])
    return [torch.from_numpy(np.stack([o[k] for o in outs]))
            for k in range(5)]


def _equal(got, want):
    return all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_matches_plain_and_jax(name, cap):
    args = CASES[name](cap)
    want = ring_insert(*args, backend="reference")
    got = kernel_model(*args)
    assert _equal(got, want)
    assert _equal(got, _jax(args))
    if name in ("full_row", "exact_room", "n_above_cap"):
        assert int(want[4].sum()) > 0            # the case drops chunks


@pytest.mark.parametrize("cap", CAPS)
def test_runs_do_not_interact(cap):
    """Each run of a batch gives what it gives alone."""
    args = CASES["runs_apart"](cap)
    got = kernel_model(*args)
    for b in range(args[0].shape[0]):
        alone = kernel_model(*(t[b:b + 1] for t in args))
        assert all(torch.equal(g[b:b + 1], a) for g, a in zip(got, alone))


@pytest.mark.parametrize("cap", CAPS)
def test_writes_before_the_barrier_go_wrong(cap):
    """Without the barrier between the phases, an item written at once
    moves the search of a later item bound for its row: the model then
    departs from the plain version wherever two items share a row."""
    args = CASES["one_row"](cap)
    want = ring_insert(*args, backend="reference")
    assert not _equal(kernel_model(*args, barrier=False), want)


@pytest.mark.parametrize("seed", range(4))
def test_scan_up_is_the_prefix_sum(seed):
    vals = torch.randint(0, 17, (WARP,),
                         generator=torch.Generator().manual_seed(seed))
    assert scan_up(vals.tolist()) == torch.cumsum(vals, 0).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_word_masks_equal_byte_masks(seed):
    """The 16-byte load's four words give the byte-by-byte mask, for
    valid bytes 0 and 1 anywhere in the unit."""
    g = torch.Generator().manual_seed(seed)
    vrow = torch.rand((8 * UNIT,), generator=g) < 0.5
    vrow[:UNIT] = False
    vrow[UNIT:2 * UNIT] = True
    for c in range(0, vrow.numel(), UNIT):
        assert free_unit(vrow, c, vrow.numel(), True) == \
            free_unit(vrow, c, vrow.numel(), False)
