"""Homa's receiver-side priority allocation (paper §3.4, Fig. 4); the
port's numpy copy of ``repro.core.priorities``.

Given a sample of the receiver's message-size distribution:
  1. compute the fraction of bytes that arrive unscheduled
     (min(size, unsched_limit) per message),
  2. allocate that fraction of the 8 levels (the highest ones) to
     unscheduled traffic, at least 1 each side when both kinds exist,
  3. choose size cutoffs between unscheduled levels so each level carries
     an equal share of unscheduled bytes (shortest messages -> highest
     priority).

The paper's implementation precomputes these from workload knowledge (§4);
we do the same, plus an online estimator (beyond-paper) in HomaReceiverState.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PriorityAllocation:
    n_prios: int
    n_unsched: int                 # highest n_unsched levels are unscheduled
    cutoffs: tuple[int, ...]       # len n_unsched-1, ascending message sizes
    unsched_bytes_frac: float

    @property
    def n_sched(self) -> int:
        return self.n_prios - self.n_unsched

    @property
    def sched_lo(self) -> int:
        return 0

    @property
    def sched_hi(self) -> int:
        return self.n_sched - 1

    def unsched_prio(self, msg_size: np.ndarray) -> np.ndarray:
        """Priority level for unscheduled packets of messages of given size.
        Highest level (n_prios-1) for the shortest messages."""
        lvl = np.searchsorted(np.asarray(self.cutoffs), msg_size, side="left")
        return (self.n_prios - 1 - lvl).astype(np.int32)


def allocate_priorities(sizes: np.ndarray, *, unsched_limit: int,
                        n_prios: int = 8,
                        force_unsched: int | None = None) -> PriorityAllocation:
    sizes = np.asarray(sizes, np.int64)
    unsched_bytes = np.minimum(sizes, unsched_limit).astype(np.float64)
    frac = float(unsched_bytes.sum() / max(sizes.sum(), 1))
    if force_unsched is not None:
        n_unsched = force_unsched
    else:
        n_unsched = int(round(frac * n_prios))
        n_unsched = min(max(n_unsched, 1), n_prios - 1)
    cutoffs = equal_bytes_cutoffs(sizes, unsched_bytes, n_unsched)
    return PriorityAllocation(n_prios, n_unsched, tuple(cutoffs), frac)


def equal_bytes_cutoffs(sizes: np.ndarray, weights: np.ndarray,
                        n_levels: int) -> list[int]:
    """Size thresholds splitting `weights` into n_levels equal-byte buckets
    by ascending size (paper Fig. 4's equal-traffic rule)."""
    if n_levels <= 1:
        return []
    order = np.argsort(sizes, kind="stable")
    s_sorted = sizes[order]
    w_cum = np.cumsum(weights[order])
    total = w_cum[-1]
    cuts = []
    for i in range(1, n_levels):
        target = total * i / n_levels
        idx = int(np.searchsorted(w_cum, target))
        idx = min(idx, len(s_sorted) - 1)
        cuts.append(int(s_sorted[idx]))
    # enforce strictly non-decreasing
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return cuts


def pias_thresholds(sizes: np.ndarray, n_prios: int = 8) -> list[int]:
    """Sender-side PIAS demotion thresholds (bytes sent so far): equalize
    bytes per level across the size distribution (approximation of PIAS's
    queue-balancing optimization)."""
    sizes = np.asarray(sizes, np.int64)
    return equal_bytes_cutoffs(sizes, sizes.astype(np.float64), n_prios)
