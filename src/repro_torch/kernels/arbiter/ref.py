"""Plain PyTorch versions of the arbitration kernels.

These are the oracles the CUDA kernels in ``csrc/arbiter.cu`` are held
to (``chip_smoke.py`` on the card, ``tests/test_torch_arbiter.py`` and
``tests/test_torch_fused.py`` against ``repro.kernels.arbiter`` and the
Pallas kernels), and what the ``reference`` backend and every CPU tensor
run. The arbitration functions reduce over the last axis, so operands
may carry any leading axes (the simulator's run axis among them);
:func:`ring_insert_ref`, the oracle of ``ring_insert_kernel``, takes
rings with one leading run axis.
"""
from __future__ import annotations

import torch

BIG = 2 ** 30      # empty-slot priority/seq; "no winner" priority
NEG = -(2 ** 30)   # missing top-K key: below every legitimate key (>= 0)


def priority_arbiter_ref(prio, seq, elig):
    """Strict-priority, FIFO-within-level selection per row.

    ``prio``/``seq`` ``(..., H, cap)`` int32, ``elig`` bool of the same
    shape. Returns ``(best_prio (..., H), best_idx (..., H))`` int32: the
    lexicographic masked argmin over (prio, seq), ties to the lowest
    column; a row with no eligible entry gives ``(BIG, 0)``.
    ``torch.argmin`` returns the first minimal index, which is the tie
    rule."""
    p = torch.where(elig, prio, BIG)
    s = torch.where(elig, seq, BIG)
    pmin = p.amin(dim=-1)
    s_cand = torch.where(p == pmin[..., None], s, BIG)
    idx = s_cand.argmin(dim=-1).to(torch.int32)
    return pmin, idx


def topk_normalize(vals, idx):
    """Raw top-K -> caller convention (``repro`` ``dispatch._topk_normalize``):
    keys clamped at 0, columns -1 where the key is not positive."""
    return vals.clamp_min(0), torch.where(vals > 0, idx, -1)


def srpt_topk_raw(keys, K: int):
    """K largest keys per row with their source columns, in the kernels'
    raw convention: ``(vals (..., K), idx (..., K))`` int32, descending,
    ties to the lowest column (``lax.top_k``'s order, which
    ``torch.sort(stable=True)`` gives and ``torch.topk`` does not
    promise); ranks past the row's width are ``(NEG, -1)``."""
    M = keys.shape[-1]
    if M < K:
        pad = keys.new_full(keys.shape[:-1] + (K - M,), NEG)
        keys = torch.cat([keys, pad], dim=-1)
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :K].contiguous(), idx[..., :K].to(torch.int32)
    return vals, torch.where(idx < M, idx, -1)


def srpt_topk_ref(keys, K: int):
    """:func:`srpt_topk_raw` normalized: keys clamped at 0, columns -1
    where fewer than K positive keys exist."""
    return topk_normalize(*srpt_topk_raw(keys, K))


def fused_slot_ref(down=None, up=None, keys=None, K: int = 0):
    """One slot's arbitration stages, each optional: ``down``/``up`` are
    ``(prio, seq, elig)`` drain problems, ``keys`` the top-K key matrix
    with ``K >= 1``. Operands may carry a leading run axis. Returns the
    raw outputs in stage order, ``[d_prio, d_idx][, u_prio, u_idx][,
    vals, idx]`` — the convention of ``fused.fused_slot`` in the JAX
    package and of the CUDA ``fused_slot_kernel``."""
    out = []
    for stage in (down, up):
        if stage is not None:
            out += priority_arbiter_ref(*stage)
    if keys is not None:
        out += srpt_topk_raw(keys, K)
    return tuple(out)


def ring_insert_ref(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq):
    """Insert up to ``n`` chunks per run into per-row rings
    (``fabric.ring_insert``'s function).

    Rings are ``(B, R, cap)``; ``row``/``ok``/``msg``/``prio``/``seq`` are
    ``(B, n)``. Item i of run b goes into ring ``row[b, i]`` of that run
    iff ``ok[b, i]``; several items may target one row in a slot (they
    take consecutive free slots in input order). A chunk is dropped only
    when its ring is actually full. Returns four new ring arrays plus the
    dropped count per run, ``(B,)`` int32."""
    # core.scatter imports the core package, which imports this module
    from repro_torch.core.scatter import set_drop
    B, R, cap = valid_a.shape
    n = row.shape[1]
    rows = torch.where(ok, row, R).long()                 # sentinel R
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=row.device).tril_(-1)
    # rank among earlier ok items of the same run bound for the same
    # row (a not-ok item's sentinel row R matches no ok item, and its
    # own rank is never used)
    rank = ((rows[:, :, None] == rows[:, None, :]) & earlier).sum(dim=2)
    # (r+1)-th free slot per row: a left binary search in the cumsum
    # of free slots, which is nondecreasing
    c = torch.cumsum(~valid_a, dim=2)                    # int64
    c_row = c.gather(1, rows.clamp_max(R - 1)[:, :, None]
                     .expand(B, n, cap))
    room = c_row[:, :, -1] > rank
    okw = ok & room
    pos = torch.searchsorted(c_row, (rank + 1)[:, :, None],
                             right=False)[:, :, 0]
    # suppressed writes are dropped, never clamped into range: an
    # in-range no-op write could race a genuine insertion at the same
    # place
    flat = rows * cap + pos
    return (set_drop(msg_a, flat, msg, okw),
            set_drop(prio_a, flat, prio, okw),
            set_drop(seq_a, flat, seq, okw),
            set_drop(valid_a, flat, okw, okw),
            (ok & ~room).sum(dim=1, dtype=torch.int32))


__all__ = ["BIG", "NEG", "priority_arbiter_ref", "srpt_topk_raw",
           "srpt_topk_ref", "topk_normalize", "fused_slot_ref",
           "ring_insert_ref"]
