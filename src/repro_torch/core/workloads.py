"""Workloads W1-W5 (paper Fig. 1), re-synthesized; the port's numpy copy
of ``repro.core.workloads``.

The paper provides W1-W5 only as CDF plots; we reconstruct them as
log-uniform mixtures matched to the described statistics (W1: >70% of bytes
in <1000 B messages; W5: DCTCP web-search, 95% of bytes in >1 MB messages;
ordering by mean size W1 < ... < W5). Generation draws from
``np.random.default_rng(seed)`` in the same order as the JAX package, so
both packages build identical tables from one seed.

Every :class:`WorkloadSpec` kind builds here: ``poisson`` (with the
optional incast overlay) in this module, ``incast`` / ``hotspot`` /
``shuffle`` in :mod:`repro_torch.core.scenarios`.
"""
from __future__ import annotations

import dataclasses

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
    try:
        bins = WORKLOAD_BINS[workload]
    except KeyError:
        raise ValueError(
            f"unknown workload {workload!r}; available workloads: "
            f"{sorted(WORKLOAD_BINS)}") from None
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


@dataclasses.dataclass
class MessageTable:
    """Open-loop Poisson message arrivals for the simulator."""
    src: np.ndarray          # (M,) int32
    dst: np.ndarray          # (M,) int32
    size: np.ndarray         # (M,) int64 bytes
    arrival_slot: np.ndarray  # (M,) int32
    workload: str
    load: float
    slot_bytes: int


_SPEC_KINDS = ("poisson", "incast", "hotspot", "shuffle")

# fields each kind requires beyond the defaults
_SPEC_REQUIRED = {
    "poisson": ("workload", "load"),
    "incast": ("fan_in", "burst_bytes"),
    "hotspot": ("workload", "load"),
    "shuffle": ("bytes_per_pair",),
}


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One frozen description of how to generate a :class:`MessageTable`.

    Unifies :func:`make_messages` and the scenario generators
    (``scenarios.incast`` / ``hotspot`` / ``shuffle``) behind one spec
    type that :class:`repro_torch.core.sweep.SweepSpec` accepts directly;
    those functions are thin wrappers over ``WorkloadSpec(...).build``,
    so generation (and its RNG draw order) is defined in one place.

    Only the fields of the chosen ``kind`` matter; topology-dependent
    parameters (``n_hosts``, ``slot_bytes``) go to :meth:`build`, so one
    spec serves every topology in a sweep.
    """
    kind: str = "poisson"            # poisson | incast | hotspot | shuffle
    # poisson / hotspot base workload
    workload: str | None = None      # W1..W5
    load: float | None = None
    n_messages: int = 2000
    seed: int = 0
    max_bytes: int | None = None
    incast: tuple[int, int, int] | None = None   # poisson burst overlay
    # incast scenario
    fan_in: int | None = None
    burst_bytes: int | None = None
    dst: int = 0
    n_bursts: int = 1
    period_slots: int = 2000
    first_slot: int = 0
    background: str | None = None
    background_load: float = 0.0
    n_background: int = 0
    # hotspot
    hot_fraction: float = 0.5
    n_hot: int = 1
    # shuffle
    bytes_per_pair: int | None = None
    spread_slots: int = 0

    def __post_init__(self):
        if self.kind not in _SPEC_KINDS:
            raise ValueError(f"unknown WorkloadSpec kind {self.kind!r}; "
                             f"one of {_SPEC_KINDS}")
        missing = [f for f in _SPEC_REQUIRED[self.kind]
                   if getattr(self, f) is None]
        if missing:
            raise ValueError(f"WorkloadSpec(kind={self.kind!r}) requires "
                             f"{missing}")
        if self.incast is not None:
            object.__setattr__(self, "incast", tuple(self.incast))

    def with_seed(self, seed: int) -> "WorkloadSpec":
        return dataclasses.replace(self, seed=seed)

    def build(self, *, n_hosts: int, slot_bytes: int = 256) -> MessageTable:
        """Generate the table for a concrete topology."""
        if self.kind == "poisson":
            return _poisson_table(self, n_hosts, slot_bytes)
        # scenario kinds live in scenarios, which builds on this module
        from repro_torch.core import scenarios
        impl = {"incast": scenarios._incast_impl,
                "hotspot": scenarios._hotspot_impl,
                "shuffle": scenarios._shuffle_impl}[self.kind]
        return impl(self, n_hosts, slot_bytes)


def _poisson_table(ws: WorkloadSpec, n_hosts: int,
                   slot_bytes: int) -> MessageTable:
    rng = np.random.default_rng(ws.seed)
    sizes = sample_sizes(ws.workload, ws.n_messages, rng, ws.max_bytes)
    # slots consumed per message on a link (ceil -> includes packetization)
    slots = np.maximum((sizes + slot_bytes - 1) // slot_bytes, 1)
    # aggregate service capacity: n_hosts slots per tick
    mean_gap = slots.mean() / (ws.load * n_hosts)
    gaps = rng.exponential(mean_gap, ws.n_messages)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    src = rng.integers(0, n_hosts, ws.n_messages)
    dst = rng.integers(0, n_hosts - 1, ws.n_messages)
    dst = np.where(dst >= src, dst + 1, dst)   # dst != src
    tbl = MessageTable(src.astype(np.int32), dst.astype(np.int32),
                       sizes, arrivals.astype(np.int32), ws.workload,
                       ws.load, slot_bytes)
    if ws.incast is not None:
        from repro_torch.core import scenarios
        fan_in, burst_bytes, period_slots = ws.incast
        if period_slots < 1:
            raise ValueError(f"incast period_slots must be >= 1, got "
                             f"{period_slots}")
        horizon = int(arrivals.max()) if ws.n_messages else 0
        bursts = scenarios.incast(
            fan_in, burst_bytes, n_hosts=n_hosts, slot_bytes=slot_bytes,
            n_bursts=max(horizon // period_slots, 1),
            period_slots=period_slots, first_slot=period_slots,
            seed=ws.seed)
        tbl = scenarios.merge_tables(tbl, bursts, workload=ws.workload,
                                     load=ws.load)
    return tbl


def make_messages(workload: str, *, n_hosts: int, load: float,
                  n_messages: int, slot_bytes: int, seed: int = 0,
                  max_bytes: int | None = None,
                  incast: tuple[int, int, int] | None = None) -> MessageTable:
    """Poisson arrivals at aggregate rate = load * n_hosts * link rate.

    Each host's downlink drains one slot (slot_bytes) per tick; `load` is the
    fraction of aggregate link bandwidth consumed by message bytes.

    ``incast=(fan_in, burst_bytes, period_slots)`` overlays periodic
    fan-in bursts on the background traffic: every ``period_slots``,
    ``fan_in`` senders each emit one ``burst_bytes`` response to host 0
    simultaneously (``scenarios.incast``), until the background's arrival
    horizon is covered.

    Thin wrapper over ``WorkloadSpec(kind="poisson", ...).build(...)``.
    """
    return WorkloadSpec(kind="poisson", workload=workload, load=load,
                        n_messages=n_messages, seed=seed,
                        max_bytes=max_bytes, incast=incast).build(
                            n_hosts=n_hosts, slot_bytes=slot_bytes)


def bytes_weighted_unsched_fraction(sizes: np.ndarray,
                                    unsched_limit: int) -> float:
    """Share of all bytes that fall inside each message's first
    ``unsched_limit`` bytes (the unscheduled, blind part)."""
    return float(np.minimum(sizes, unsched_limit).sum() / sizes.sum())


__all__ = ["WORKLOAD_BINS", "sample_sizes", "MessageTable", "WorkloadSpec",
           "make_messages", "bytes_weighted_unsched_fraction"]
