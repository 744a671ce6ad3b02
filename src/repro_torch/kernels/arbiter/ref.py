"""Plain PyTorch versions of the two arbitration kernels.

These are the oracles the CUDA kernels in ``csrc/arbiter.cu`` are held
to (``chip_smoke.py`` on the card, ``tests/test_torch_arbiter.py`` against
``repro.kernels.arbiter.ref`` and the Pallas kernels), and what the
``reference`` backend and every CPU tensor run.
"""
from __future__ import annotations

import torch

BIG = 2 ** 30      # empty-slot priority/seq; "no winner" priority
NEG = -(2 ** 30)   # missing top-K key: below every legitimate key (>= 0)


def priority_arbiter_ref(prio, seq, elig):
    """Strict-priority, FIFO-within-level selection per row.

    ``prio``/``seq`` ``(H, cap)`` int32, ``elig`` ``(H, cap)`` bool.
    Returns ``(best_prio (H,), best_idx (H,))`` int32: the lexicographic
    masked argmin over (prio, seq), ties to the lowest column; a row with
    no eligible entry gives ``(BIG, 0)``. ``torch.argmin`` returns the
    first minimal index, which is the tie rule."""
    p = torch.where(elig, prio, BIG)
    s = torch.where(elig, seq, BIG)
    pmin = p.amin(dim=1)
    s_cand = torch.where(p == pmin[:, None], s, BIG)
    idx = s_cand.argmin(dim=1).to(torch.int32)
    return pmin, idx


def topk_normalize(vals, idx):
    """Raw top-K -> caller convention (``repro`` ``dispatch._topk_normalize``):
    keys clamped at 0, columns -1 where the key is not positive."""
    return vals.clamp_min(0), torch.where(vals > 0, idx, -1)


def srpt_topk_ref(keys, K: int):
    """K largest keys per row plus their source columns.

    Returns ``(vals (H, K), idx (H, K))`` int32: descending keys clamped
    at 0, columns -1 where fewer than K positive keys exist. Ties go to
    the lowest column (``lax.top_k``'s order), which ``torch.sort(stable=
    True)`` gives and ``torch.topk`` does not promise. Rows shorter than
    K pad with ``NEG``, never 0, which is a legitimate key."""
    H, M = keys.shape
    if M < K:
        keys = torch.cat([keys, keys.new_full((H, K - M), NEG)], dim=1)
    vals, idx = torch.sort(keys, dim=1, descending=True, stable=True)
    return topk_normalize(vals[:, :K].contiguous(),
                          idx[:, :K].to(torch.int32))


__all__ = ["BIG", "NEG", "priority_arbiter_ref", "srpt_topk_ref",
           "topk_normalize"]
