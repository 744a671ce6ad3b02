"""Poisson arrivals of W1-W5 messages, the generator of every sweep mix.

A frozen copy of the port's ``make_messages`` (``repro_torch.core.
workloads``, the ``poisson`` kind without the incast overlay): the same
bins and the same draws from ``np.random.default_rng(seed)`` in the same
order, so the benchmark builds its inputs itself and hands the same
arrays to the program and to the reference. The bins are the repo's
reconstruction of the paper's Fig. 1 CDFs as log-uniform mixtures.

A mix (``traffic/<name>.json``) names this module as its ``generator``
and gives ``workload``, ``loads``, ``seeds_per_load``, ``n_messages`` and
optionally ``max_bytes``. Run ``j`` of every load draws its table from
the ``j``-th seed that :func:`table_seeds` derives from the run's
``--seed``, so one seed index is the same traffic pattern at every load,
as in a paper figure's grid.
"""
from __future__ import annotations

import numpy as np

# (probability, lo_bytes, hi_bytes) bins; sizes log-uniform within a bin
WORKLOAD_BINS: dict[str, list[tuple[float, int, int]]] = {
    "W1": [(0.55, 10, 100), (0.40, 100, 1_000), (0.048, 1_000, 10_000),
           (0.002, 10_000, 30_000)],
    "W2": [(0.30, 3, 100), (0.40, 100, 2_000), (0.20, 2_000, 10_000),
           (0.08, 10_000, 100_000), (0.02, 100_000, 1_000_000)],
    "W3": [(0.25, 10, 300), (0.35, 300, 2_000), (0.25, 2_000, 20_000),
           (0.12, 20_000, 200_000), (0.03, 200_000, 2_000_000)],
    "W4": [(0.10, 30, 300), (0.25, 300, 3_000), (0.30, 3_000, 30_000),
           (0.25, 30_000, 300_000), (0.10, 300_000, 3_000_000)],
    "W5": [(0.40, 1_000, 10_000), (0.30, 10_000, 100_000),
           (0.20, 100_000, 1_000_000), (0.10, 1_000_000, 30_000_000)],
}


def sample_sizes(workload: str, n: int, rng: np.random.Generator,
                 max_bytes: int | None = None) -> np.ndarray:
    bins = WORKLOAD_BINS[workload]
    ps = np.array([b[0] for b in bins])
    ps = ps / ps.sum()
    which = rng.choice(len(bins), size=n, p=ps)
    lo = np.array([b[1] for b in bins])[which].astype(np.float64)
    hi = np.array([b[2] for b in bins])[which].astype(np.float64)
    u = rng.random(n)
    sizes = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    sizes = np.maximum(sizes.astype(np.int64), 1)
    if max_bytes:
        sizes = np.minimum(sizes, max_bytes)
    return sizes


def make_table(workload: str, *, n_hosts: int, load: float,
               n_messages: int, slot_bytes: int, seed: int,
               max_bytes: int | None = None) -> dict:
    """One run's messages: ``src``, ``dst`` (int32, never equal),
    ``size`` (int64 bytes) and ``arrival_slot`` (int32), Poisson arrivals
    at ``load`` of the hosts' aggregate link rate."""
    rng = np.random.default_rng(seed)
    sizes = sample_sizes(workload, n_messages, rng, max_bytes)
    slots = np.maximum((sizes + slot_bytes - 1) // slot_bytes, 1)
    mean_gap = slots.mean() / (load * n_hosts)
    gaps = rng.exponential(mean_gap, n_messages)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    src = rng.integers(0, n_hosts, n_messages)
    dst = rng.integers(0, n_hosts - 1, n_messages)
    dst = np.where(dst >= src, dst + 1, dst)
    return {"src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "size": sizes, "arrival_slot": arrivals.astype(np.int32),
            "workload": workload, "load": float(load),
            "slot_bytes": slot_bytes}


def table_seeds(seed: int, n: int) -> list[int]:
    """``n`` table seeds derived from a run's ``--seed`` (any whole
    number, larger than 32 bits included)."""
    state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
        n, dtype=np.uint64)
    return [int(s) for s in state]


def tables(mix: dict, config: dict, seed: int) -> list[dict]:
    """Every run's table, load by load, ``seeds_per_load`` runs a load."""
    seeds = table_seeds(seed, mix["seeds_per_load"])
    return [make_table(mix["workload"], n_hosts=config["n_hosts"],
                       load=load, n_messages=mix["n_messages"],
                       slot_bytes=config["slot_bytes"], seed=s,
                       max_bytes=mix.get("max_bytes"))
            for load in mix["loads"] for s in seeds]
