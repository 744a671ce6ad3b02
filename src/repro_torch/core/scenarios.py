"""Structured traffic scenarios layered on :mod:`repro_torch.core.workloads`;
the port's numpy copy of ``repro.core.scenarios``.

Each generator returns an ordinary :class:`MessageTable`, so scenarios
run through ``simulate`` / ``run_sweep`` with no simulator changes:

  ``incast``   fan-in burst: N servers answer one client at once
               (paper Fig. 14), optionally repeated and overlaid on
               Poisson background traffic.
  ``hotspot``  skewed destination popularity — a fraction of all
               messages targets a small hot set of hosts.
  ``shuffle``  all-to-all: every ordered host pair exchanges one
               fixed-size message (map-reduce shuffle).

All generators are deterministic in ``seed``, draw from numpy in the JAX
package's order (so both packages build identical tables), and are thin
wrappers over :class:`repro_torch.core.workloads.WorkloadSpec`; the
``_*_impl`` functions hold the generation and are dispatched from
``WorkloadSpec.build``.

Failure scenarios live on the fabric axis: ``FabricConfig.with_lossy`` /
``.with_uplink_failure`` / ``.with_tor_failure`` attach a
:class:`~repro_torch.core.faults.FaultConfig`; ``lossy_fabric`` /
``uplink_failure`` / ``tor_failure`` here are thin wrappers over them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.fabric import FabricConfig
from repro_torch.core.workloads import (MessageTable, WorkloadSpec,
                                        make_messages)


def merge_tables(a: MessageTable, b: MessageTable, *, workload: str,
                 load: float) -> MessageTable:
    """Concatenate two tables and re-sort by arrival (stable, so same-slot
    ordering keeps background before burst within a slot). Public: the
    overlay primitive scenario generators and ``make_messages``' incast
    wiring both build on."""
    if a.slot_bytes != b.slot_bytes:
        raise ValueError(
            f"cannot merge tables with different slot sizes "
            f"({a.slot_bytes} vs {b.slot_bytes} bytes): the simulator "
            f"packetizes every message at one slot granularity")
    src = np.concatenate([a.src, b.src])
    dst = np.concatenate([a.dst, b.dst])
    size = np.concatenate([a.size, b.size])
    arr = np.concatenate([a.arrival_slot, b.arrival_slot])
    order = np.argsort(arr, kind="stable")
    return MessageTable(src[order].astype(np.int32),
                        dst[order].astype(np.int32),
                        size[order].astype(np.int64),
                        arr[order].astype(np.int32),
                        workload, load, a.slot_bytes)


def incast(fan_in: int, burst_bytes: int, *, n_hosts: int,
           slot_bytes: int = 256, dst: int = 0, n_bursts: int = 1,
           period_slots: int = 2000, first_slot: int = 0,
           background: str | None = None, background_load: float = 0.0,
           n_background: int = 0, seed: int = 0) -> MessageTable:
    """Fan-in burst scenario (paper Fig. 14 shape).

    Every ``period_slots`` (starting at ``first_slot``), ``fan_in``
    distinct senders each emit one ``burst_bytes`` response to ``dst``
    simultaneously — the application issued a request to ``fan_in``
    servers and all replies collide at one downlink. Senders are chosen
    round-robin over the other hosts so bursts span racks under any
    rack partition. With ``background``/``background_load``/
    ``n_background`` set, a Poisson workload table is overlaid.
    """
    return WorkloadSpec(
        kind="incast", fan_in=fan_in, burst_bytes=burst_bytes, dst=dst,
        n_bursts=n_bursts, period_slots=period_slots,
        first_slot=first_slot, background=background,
        background_load=background_load, n_background=n_background,
        seed=seed).build(n_hosts=n_hosts, slot_bytes=slot_bytes)


def _incast_impl(ws: WorkloadSpec, n_hosts: int,
                 slot_bytes: int) -> MessageTable:
    fan_in, dst, seed = ws.fan_in, ws.dst, ws.seed
    if not 1 <= fan_in <= n_hosts - 1:
        raise ValueError(f"incast fan_in must be in [1, n_hosts-1], got "
                         f"{fan_in} with n_hosts={n_hosts}")
    others = np.array([h for h in range(n_hosts) if h != dst], np.int32)
    rng = np.random.default_rng(seed)
    srcs, arrs = [], []
    for b in range(ws.n_bursts):
        start = int(rng.integers(len(others)))      # rotate the sender set
        sel = others[(start + np.arange(fan_in)) % len(others)]
        srcs.append(sel)
        arrs.append(np.full(fan_in, ws.first_slot + b * ws.period_slots))
    src = np.concatenate(srcs).astype(np.int32)
    arr = np.concatenate(arrs).astype(np.int32)
    tbl = MessageTable(src, np.full_like(src, dst),
                       np.full(len(src), ws.burst_bytes, np.int64),
                       arr, f"incast{fan_in}x{ws.burst_bytes}", 0.0,
                       slot_bytes)
    if ws.n_background and ws.background:
        bg = make_messages(ws.background, n_hosts=n_hosts,
                           load=ws.background_load,
                           n_messages=ws.n_background,
                           slot_bytes=slot_bytes, seed=seed + 1)
        tbl = merge_tables(bg, tbl, workload=f"incast+{ws.background}",
                           load=ws.background_load)
    return tbl


def hotspot(workload: str, *, n_hosts: int, load: float, n_messages: int,
            slot_bytes: int = 256, hot_fraction: float = 0.5,
            n_hot: int = 1, seed: int = 0) -> MessageTable:
    """Skewed destination popularity: ``hot_fraction`` of all messages
    are redirected to a hot set of ``n_hot`` hosts (the first ``n_hot``
    host ids), the rest keep their uniform destinations. Sizes and
    arrivals come from the base Poisson workload unchanged."""
    return WorkloadSpec(
        kind="hotspot", workload=workload, load=load,
        n_messages=n_messages, hot_fraction=hot_fraction, n_hot=n_hot,
        seed=seed).build(n_hosts=n_hosts, slot_bytes=slot_bytes)


def _hotspot_impl(ws: WorkloadSpec, n_hosts: int,
                  slot_bytes: int) -> MessageTable:
    if not 0.0 <= ws.hot_fraction <= 1.0:
        raise ValueError(f"hot_fraction must be in [0, 1], got "
                         f"{ws.hot_fraction}")
    if not 1 <= ws.n_hot < n_hosts:
        raise ValueError(f"n_hot must be in [1, n_hosts), got {ws.n_hot}")
    tbl = make_messages(ws.workload, n_hosts=n_hosts, load=ws.load,
                        n_messages=ws.n_messages, slot_bytes=slot_bytes,
                        seed=ws.seed, max_bytes=ws.max_bytes)
    rng = np.random.default_rng(ws.seed + 0x5EED)
    redirect = rng.random(ws.n_messages) < ws.hot_fraction
    hot_dst = rng.integers(0, ws.n_hot, ws.n_messages).astype(np.int32)
    dst = np.where(redirect, hot_dst, tbl.dst).astype(np.int32)
    # a hot host never sends to itself: bounce to the next host id
    clash = dst == tbl.src
    dst[clash] = (dst[clash] + 1) % n_hosts
    return MessageTable(tbl.src, dst, tbl.size, tbl.arrival_slot,
                        f"hotspot:{ws.workload}", ws.load, slot_bytes)


def shuffle(*, n_hosts: int, bytes_per_pair: int, slot_bytes: int = 256,
            spread_slots: int = 0, seed: int = 0) -> MessageTable:
    """All-to-all shuffle: every ordered pair (i, j), i != j, exchanges
    one ``bytes_per_pair`` message. Arrivals are uniform over
    ``spread_slots`` (0 = everything starts at slot 0) in a seeded
    random pair order — the map-reduce shuffle that saturates
    oversubscribed TOR uplinks."""
    return WorkloadSpec(
        kind="shuffle", bytes_per_pair=bytes_per_pair,
        spread_slots=spread_slots, seed=seed).build(
            n_hosts=n_hosts, slot_bytes=slot_bytes)


def _shuffle_impl(ws: WorkloadSpec, n_hosts: int,
                  slot_bytes: int) -> MessageTable:
    pairs = np.array([(i, j) for i in range(n_hosts)
                      for j in range(n_hosts) if i != j], np.int32)
    rng = np.random.default_rng(ws.seed)
    order = rng.permutation(len(pairs))
    pairs = pairs[order]
    if ws.spread_slots > 0:
        arr = np.sort(rng.integers(0, ws.spread_slots, len(pairs)))
    else:
        arr = np.zeros(len(pairs), np.int64)
    return MessageTable(pairs[:, 0], pairs[:, 1],
                        np.full(len(pairs), ws.bytes_per_pair, np.int64),
                        arr.astype(np.int32), "shuffle", 1.0, slot_bytes)


# ------------------------------------------------- failure scenarios ------
# Thin wrappers: failure scenarios are FabricConfig.with_* methods (they
# transform the fabric, so they live on it).

def lossy_fabric(fab: FabricConfig, **kw) -> FabricConfig:
    """Thin wrapper over :meth:`FabricConfig.with_lossy`."""
    return fab.with_lossy(**kw)


def uplink_failure(fab: FabricConfig, **kw) -> FabricConfig:
    """Thin wrapper over :meth:`FabricConfig.with_uplink_failure`."""
    return fab.with_uplink_failure(**kw)


def tor_failure(fab: FabricConfig, **kw) -> FabricConfig:
    """Thin wrapper over :meth:`FabricConfig.with_tor_failure`."""
    return fab.with_tor_failure(**kw)


__all__ = ["incast", "hotspot", "shuffle", "merge_tables",
           "lossy_fabric", "uplink_failure", "tor_failure"]
