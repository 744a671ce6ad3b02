"""Batched sweeps with streaming statistics (DESIGN.md §9); the port of
``repro.core.sweep``.

``run_sweep(cfg, spec)`` runs the independent simulations one
:class:`SweepSpec` describes. Runs are grouped by the step's static
parameters ``(table length, scheduled levels)`` (:func:`group_runs`),
and each group steps as ONE batch on the leading run axis of
``sim.step_fn``: every slot enqueues the same operations for B runs as
for one, and on ``backend="fused"`` one ``fused_slot_batch`` launch
arbitrates all B runs' slot. Every run is independent, so batched
results are bit-identical to sequential ``simulate`` calls.

**Chunked steps.** ``chunk_slots=c`` steps the batch ``c`` slots at a
time — the same step sequence, so the same state — and folds the
streaming histogram at every chunk boundary.

**Streaming stats.** With ``streaming`` on, a run's slowdowns are binned
on the device into a fixed log-spaced histogram (size bucket x slowdown
bucket), and only O(buckets) numbers per run are copied to the host —
never the (B, M) per-message arrays. Percentile estimates from the
histogram carry a documented relative error bound of half a bucket in
log space (:meth:`StreamSpec.rel_err_bound`, ~0.9% at the defaults).
Queue/busy/priority counters reduce exactly; ``q_sum`` and the host
stage's ``h_tx_work`` sum in float64 (their per-host values are integers,
so the float64 sums are exact, where the JAX package's float32 sums may
round). A captured trace reduces on the device to its peaks and event
count (``telemetry.reduce_state``); an exact sweep keeps its trace's
scalars (``SimResult.trace_summary``) and not the series.

**Sharding.** ``shard`` = n > 1 splits the run axis over the first n
ranks of ``torch.distributed``'s default process group (``True``: all of
them), which every rank of that group enters together. Each rank
resolves and prepares every table (``shared_alloc`` over all of them)
and groups every run; each group is padded to a multiple of n by
replicating its last run, and rank r steps the contiguous block r of
each group as one batch on its own device (``cfg.device``; a bare
``"cuda"`` is card ``r % device_count()``, so several ranks may share a
card). The blocks' host rows — the final state, or the streaming
summary — are gathered over gloo on the CPU, the padding rows are
dropped, and every rank returns the full list in input order. Every
run is independent, so the result is bit-identical to one process. A
rank that fails makes the gather raise on every rank. The split is over
processes, not over the devices of one process: the slot loop is bound
by its host, so one process gains nothing from a second card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import sim, spans, telemetry
from repro_torch.core.hostmodel import QSCALE
from repro_torch.core.priorities import allocate_priorities
from repro_torch.core.protocols import I32, get_protocol
from repro_torch.core.workloads import MessageTable, WorkloadSpec, \
    make_messages

# message-size bucket upper bounds (bytes) for streaming per-size
# percentiles; 1000 B is the "small message" boundary every summary uses
DEFAULT_SIZE_EDGES = (256, 1_000, 4_096, 16_384, 65_536, 262_144,
                      1_048_576)


# ================================================================ specs ==

@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Streaming-accumulator parameters. Slowdowns are binned into
    ``n_buckets`` log-spaced buckets spanning ``[1, max_slowdown)`` (the
    last bucket absorbs anything larger); sizes into ``len(size_edges) +
    1`` buckets."""
    n_buckets: int = 512
    max_slowdown: float = 1e4
    size_edges: tuple = DEFAULT_SIZE_EDGES
    small_bytes: int = 1_000            # must be one of size_edges
    warmup_frac: float = 0.0            # drop first fraction of arrivals

    def __post_init__(self):
        if self.n_buckets < 2:
            raise ValueError(f"StreamSpec.n_buckets must be >= 2, got "
                             f"{self.n_buckets}")
        if self.max_slowdown <= 1.0:
            raise ValueError(f"StreamSpec.max_slowdown must be > 1, got "
                             f"{self.max_slowdown}")
        edges = tuple(int(e) for e in self.size_edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"StreamSpec.size_edges must be strictly "
                             f"increasing, got {self.size_edges}")
        object.__setattr__(self, "size_edges", edges)
        if self.small_bytes not in edges:
            raise ValueError(
                f"StreamSpec.small_bytes={self.small_bytes} must be one "
                f"of size_edges {edges} so the small-message percentile "
                f"is a bucket boundary, not an approximation")
        if not 0.0 <= self.warmup_frac < 1.0:
            raise ValueError(f"StreamSpec.warmup_frac must be in [0, 1), "
                             f"got {self.warmup_frac}")

    @property
    def n_size_buckets(self) -> int:
        return len(self.size_edges) + 1

    @property
    def bucket_ratio(self) -> float:
        """Multiplicative width of one slowdown bucket."""
        return self.max_slowdown ** (1.0 / (self.n_buckets - 1))

    @property
    def rel_err_bound(self) -> float:
        """Documented relative error of a percentile estimate vs any
        sample in its bucket: half a bucket in log space."""
        return math.sqrt(self.bucket_ratio) - 1.0


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One frozen description of a whole sweep — the single argument of
    ``run_sweep(cfg, spec)``.

    Exactly one run source: ``tables`` (MessageTables, lengths may
    differ — runs group by static parameters), or ``seeds`` +
    ``workload`` + ``load`` (one synthesized table per seed).
    ``workload`` also accepts a :class:`WorkloadSpec`; it carries its own
    load, so ``load`` must then stay ``None`` and each seed re-seeds the
    spec. ``alloc`` / ``unsched_limit_bytes`` accept a single value or
    one entry per table.

    ``shard`` = False | True | int (devices; the port runs one);
    ``chunk_slots`` steps the batch in chunks (bit-identical; the
    streaming fold interval); ``streaming`` = False | True (default
    StreamSpec) | a StreamSpec — results become :class:`SweepStats`.
    """
    tables: tuple[MessageTable, ...] | None = None
    seeds: tuple[int, ...] | None = None
    workload: str | WorkloadSpec | None = None
    load: float | None = None
    n_messages: int = 2000
    alloc: Any = None
    unsched_limit_bytes: Any = None
    shared_alloc: bool = False
    shard: bool | int = False
    chunk_slots: int | None = None
    streaming: bool | StreamSpec = False
    return_state: bool = False

    def __post_init__(self):
        if self.tables is not None:
            object.__setattr__(self, "tables", tuple(self.tables))
        elif self.seeds is None or self.workload is None \
                or (self.load is None
                    and not isinstance(self.workload, WorkloadSpec)):
            raise ValueError("SweepSpec needs `tables` or "
                             "(`seeds`, `workload`, `load`) — "
                             "`workload` may be a WorkloadSpec carrying "
                             "its own load/shape parameters")
        if isinstance(self.workload, WorkloadSpec) \
                and self.load is not None:
            raise ValueError("load is part of the WorkloadSpec; don't "
                             "pass SweepSpec.load alongside one")
        if self.seeds is not None:
            object.__setattr__(self, "seeds",
                               tuple(int(s) for s in self.seeds))
        if self.chunk_slots is not None and self.chunk_slots < 1:
            raise ValueError(f"SweepSpec.chunk_slots must be >= 1, got "
                             f"{self.chunk_slots}")
        if self.streaming is True:
            object.__setattr__(self, "streaming", StreamSpec())
        if self.stream is not None and self.return_state:
            raise ValueError("streaming sweeps never materialize scan "
                             "state; return_state=True needs an exact "
                             "(non-streaming) sweep")

    @property
    def stream(self) -> StreamSpec | None:
        return self.streaming if isinstance(self.streaming, StreamSpec) \
            else None

    def resolve_tables(self, cfg) -> list[MessageTable]:
        if self.tables is not None:
            return list(self.tables)
        if isinstance(self.workload, WorkloadSpec):
            return [self.workload.with_seed(s).build(
                n_hosts=cfg.n_hosts, slot_bytes=cfg.slot_bytes)
                for s in self.seeds]
        return [make_messages(self.workload, n_hosts=cfg.n_hosts,
                              load=self.load, n_messages=self.n_messages,
                              slot_bytes=cfg.slot_bytes, seed=s)
                for s in self.seeds]


def resolve_devices(shard: bool | int) -> int:
    """``shard`` knob -> the number of ranks of the default process group
    the run axis splits over (``True``: the group's size, 1 without a
    group). Asking for more ranks than the group has, or for more than
    one without a group, raises."""
    if shard is False or shard is None:
        return 1
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if shard is True else int(shard)
    if n < 1 or n > world:
        raise ValueError(
            f"SweepSpec.shard={shard!r} asks for {n} devices (ranks) but "
            + (f"the default process group has {world}" if grouped else
               "no process group is initialized: call torch.distributed."
               "init_process_group on every rank first"))
    return n


def _rank_device(device: str, rank: int) -> str:
    """The device of ``rank``: a bare ``"cuda"`` is card ``rank %
    device_count()``; any other device is every rank's."""
    return f"cuda:{rank % torch.cuda.device_count()}" \
        if device == "cuda" else device


def _gather_blocks(blocks: dict, err: Exception | None, n: int) -> list:
    """Every rank's ``blocks`` (group index -> host rows), in rank order,
    gathered over gloo on the CPU (a gloo group is made for it when the
    default group is not gloo). A rank that failed (``err``) makes every
    rank raise."""
    group = None if dist.get_backend() == "gloo" \
        else dist.new_group(backend="gloo")
    got = [None] * dist.get_world_size()
    try:
        dist.all_gather_object(
            got, (blocks, None if err is None
                  else f"{type(err).__name__}: {err}"), group=group)
    finally:
        if group is not None:
            dist.destroy_process_group(group)
    failed = {r: msg for r, (_, msg) in enumerate(got) if msg is not None}
    if failed:
        raise RuntimeError(f"run_sweep: the sharded sweep failed on rank(s) "
                           f"{failed}; no rank returns a result") from err
    return [b for b, _ in got[:n]]


def group_runs(keys: list[tuple]) -> dict[tuple, list[int]]:
    """Group run indices by their static step parameters (each distinct
    key is one batch; input order is preserved within groups)."""
    groups: dict[tuple, list[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


# ================================================= streaming primitives ==

def sd_bucket_edges(stream: StreamSpec) -> np.ndarray:
    """Interior bucket edges (n_buckets - 1,): bucket b spans
    ``[r^b, r^(b+1))`` with r = :meth:`StreamSpec.bucket_ratio` (bucket 0
    starts at slowdown 1.0; the last bucket is open-ended)."""
    B = stream.n_buckets
    return (stream.bucket_ratio
            ** np.arange(1, B, dtype=np.float64)).astype(np.float32)


def bucket_mid(stream: StreamSpec, b) -> np.ndarray:
    """Geometric midpoint of slowdown bucket ``b`` (the estimator's
    representative value; error vs any member <= rel_err_bound)."""
    return stream.bucket_ratio ** (np.asarray(b, np.float64) + 0.5)


def streaming_hist(slowdowns, stream: StreamSpec) -> np.ndarray:
    """Host-side mirror of the device binning (float32 + searchsorted,
    exactly as :func:`_fold_hist` computes it)."""
    sd = np.asarray(slowdowns, np.float32)
    b = np.searchsorted(sd_bucket_edges(stream), sd, side="right")
    b = np.clip(b, 0, stream.n_buckets - 1)
    return np.bincount(b, minlength=stream.n_buckets).astype(np.int64)


def percentile_from_hist(hist, stream: StreamSpec, q: float
                         ) -> float | None:
    """Percentile estimate from a slowdown histogram: the geometric
    midpoint of the bucket holding rank ``q/100 * (n-1)`` (numpy's
    linear-interpolation position)."""
    h = np.asarray(hist)
    n = int(h.sum())
    if n == 0:
        return None
    rank = q / 100.0 * (n - 1)
    b = int(np.searchsorted(np.cumsum(h), rank, side="right"))
    return float(bucket_mid(stream, min(b, len(h) - 1)))


def streaming_percentile(slowdowns, q: float, stream: StreamSpec
                         ) -> float | None:
    """End-to-end host mirror: bin then estimate."""
    return percentile_from_hist(streaming_hist(slowdowns, stream),
                                stream, q)


def _pack_aux(stream: StreamSpec, table: MessageTable, device) -> dict:
    """Per-run static tensors the streaming fold needs beside S: the
    size-bucket index of every message and the warmup-window mask."""
    M = len(table.size)
    szb = np.searchsorted(np.asarray(stream.size_edges, np.int64),
                          table.size, side="right").astype(np.int64)
    counted = np.arange(M) >= int(M * stream.warmup_frac)
    return {"szb": torch.from_numpy(szb).to(device),
            "counted": torch.from_numpy(counted).to(device)}


def _fold_hist(stream: StreamSpec, edges, acc, st, S, aux, lo: int,
               hi: int):
    """Fold messages of every run that completed in slot window ``[lo,
    hi)`` into its flat (size-bucket x slowdown-bucket) count histogram,
    ``acc`` ``(B, K * n_buckets)``. Completion slots are immutable once
    set, so across chunk folds every message is counted exactly once.
    ``sd`` is a float32 division as in the JAX package (IEEE division is
    correctly rounded on every device) and the bucket a right-sided
    search in the float32 ``edges``."""
    Bk = stream.n_buckets
    comp = st["completion"]
    m = (comp >= lo) & (comp < hi) & aux["counted"]
    sd = (comp - S["arrival"] + 1).to(torch.float32) \
        / S["ideal"].to(torch.float32)
    b = torch.searchsorted(edges, sd, right=True)
    flat = aux["szb"] * Bk + b.clamp(0, Bk - 1)
    return acc.scatter_add(1, flat, m.to(I32))


def _device_summary(cfg, st, acc) -> dict:
    """Reduce a batch's final state to the streaming gather set, ``(B,
    ...)`` per key; the per-message and ring state never leaves the
    device. Integer counters reduce exactly; ``q_sum`` sums its
    integer-valued float32 entries in float64, which is exact, and so
    does ``h_tx_work`` its int32 micro-slots (their total can pass
    2**31)."""
    out = {
        "hist": acc,
        "n_complete": (st["completion"] >= 0).sum(dim=1),
        "busy": st["busy"].sum(dim=1), "wasted": st["wasted"].sum(dim=1),
        "uplink_busy": st["uplink_busy"].sum(dim=1),
        "q_sum": st["q_sum"].to(torch.float64).sum(dim=1),
        "q_max": st["q_max"].amax(dim=1),
        "prio_drained": st["prio_drained"],
        "lost": st["lost"] + (st["u_lost"] if cfg.fabric_on else 0),
    }
    if cfg.fabric_on:
        out["u_busy"] = st["u_busy"].sum(dim=1)
    if cfg.faults_on:
        out["f_lost"] = st["f_lost"]
        out["retx"] = st["retx"].sum(dim=1)
    if cfg.host_tx_on:
        out["h_tx_work"] = st["h_tx_work_q"].to(torch.float64).sum(dim=1)
        out["h_tx_defer"] = st["h_tx_defer"].sum(dim=1)
    if cfg.host_rx_on:
        out["h_rx_stall"] = st["h_rx_stall"].sum(dim=1)
        out["h_rx_q_max"] = st["h_rx_q_max"].amax(dim=1)
    if cfg.trace_on:
        out.update(telemetry.reduce_state(cfg, st))
    return out


# ======================================================= chunked runner ==

def _run_batch(cfg, proto, S, aux, n_sched: int, chunk: int | None,
               stream: StreamSpec | None):
    """Step one group's batch through ``cfg.max_slots`` slots, ``chunk``
    slots at a time, folding the streaming histogram at each chunk
    boundary. Returns the final state and the histogram (``None`` for an
    exact sweep)."""
    B, M = S["size"].shape
    st = sim._init_state(cfg, proto, M, B)
    acc = edges = None
    if stream is not None:
        acc = torch.zeros((B, stream.n_size_buckets * stream.n_buckets),
                          dtype=I32, device=cfg.device)
        edges = torch.from_numpy(sd_bucket_edges(stream)).to(cfg.device)
    step = chunk if chunk and chunk < cfg.max_slots else cfg.max_slots
    with torch.inference_mode():
        for lo in range(0, cfg.max_slots, step):
            hi = min(lo + step, cfg.max_slots)
            with spans.span("sweep.step"):
                st = sim.run_slots(cfg, proto, S, st, n_sched, lo, hi)
            if stream is not None:
                acc = _fold_hist(stream, edges, acc, st, S, aux, lo, hi)
    return st, acc


# ============================================================== results ==

@dataclasses.dataclass
class SweepStats:
    """One streaming run's bounded-size statistics (the SweepSpec
    ``streaming`` result type). ``hist`` is the (size buckets, slowdown
    buckets) completion-count table; everything else reduced exactly
    from the loop's running counters; the host-stage fields are ``None``
    without a host stage, ``trace_summary`` without tracing."""
    protocol: str
    stream: StreamSpec
    alloc: Any
    n_messages: int
    n_complete: int
    hist: np.ndarray                 # (K, B) int counts
    busy_frac: float
    wasted_frac: float
    uplink_busy_frac: float
    q_mean_bytes: float
    q_max_bytes: float
    prio_drained_bytes: np.ndarray   # (n_prios,)
    lost_chunks: int
    tor_up_busy_frac: float | None = None
    fault_lost_chunks: int | None = None
    retx_chunks: int | None = None
    host_tx_busy_frac: float | None = None
    host_tx_defer_frac: float | None = None
    host_rx_stall_frac: float | None = None
    host_rx_q_max_chunks: int | None = None
    trace_summary: dict | None = None

    @property
    def completion_rate(self) -> float:
        return self.n_complete / self.n_messages if self.n_messages \
            else 0.0

    @property
    def n_counted(self) -> int:
        """Completions inside the warmup-trimmed window (hist mass)."""
        return int(self.hist.sum())

    def percentile(self, q: float) -> float | None:
        """Streaming slowdown percentile over all counted messages
        (error <= ``stream.rel_err_bound`` in the relative sense)."""
        return percentile_from_hist(self.hist.sum(axis=0), self.stream,
                                    q)

    def percentile_small(self, q: float) -> float | None:
        """Percentile over messages smaller than ``stream.small_bytes``
        (exact split: small_bytes is a size-bucket edge)."""
        ks = int(np.searchsorted(np.asarray(self.stream.size_edges),
                                 self.stream.small_bytes, "left")) + 1
        return percentile_from_hist(self.hist[:ks].sum(axis=0),
                                    self.stream, q)

    def percentiles_by_size(self, pct: float = 99.0) -> dict:
        """Per-size-bucket percentile curve (buckets are the static
        ``size_edges``)."""
        edges = (1,) + self.stream.size_edges + (None,)
        out = {"sizes": [], "p": [], "median": [], "count": []}
        for k in range(self.stream.n_size_buckets):
            h = self.hist[k]
            cnt = int(h.sum())
            if cnt == 0:
                continue
            lo = edges[k]
            hi = edges[k + 1] or lo * 4
            out["sizes"].append(float(math.sqrt(lo * hi)))
            out["p"].append(percentile_from_hist(h, self.stream, pct))
            out["median"].append(percentile_from_hist(h, self.stream,
                                                      50.0))
            out["count"].append(cnt)
        return out

    def summary(self, *, pct: float = 99.0) -> dict:
        """JSON-safe aggregate summary (the JAX package's keys)."""
        r = lambda v: None if v is None else round(float(v), 6)  # noqa: E731
        return {
            "protocol": self.protocol,
            "n_complete": int(self.n_complete),
            "n_messages": int(self.n_messages),
            "completion_rate": r(self.completion_rate),
            "p99_by_size": self.percentiles_by_size(pct),
            "busy_frac": r(self.busy_frac),
            "wasted_frac": r(self.wasted_frac),
            "uplink_busy_frac": r(self.uplink_busy_frac),
            "q_mean_bytes": r(self.q_mean_bytes),
            "q_max_bytes": r(self.q_max_bytes),
            "prio_drained_bytes": [int(x) for x in
                                   self.prio_drained_bytes],
            "lost_chunks": int(self.lost_chunks),
            "p99_small": r(self.percentile_small(pct)),
            "p50_small": r(self.percentile_small(50.0)),
            "p99_all": r(self.percentile(pct)),
            "p50_all": r(self.percentile(50.0)),
            "streaming": {
                "n_buckets": self.stream.n_buckets,
                "max_slowdown": self.stream.max_slowdown,
                "rel_err_bound": r(self.stream.rel_err_bound),
                "n_counted": self.n_counted,
                "warmup_frac": self.stream.warmup_frac,
            },
            "host": None
            if self.host_tx_busy_frac is None
            and self.host_rx_stall_frac is None else {
                "tx_busy_frac": r(self.host_tx_busy_frac),
                "tx_defer_frac": r(self.host_tx_defer_frac),
                "rx_stall_frac": r(self.host_rx_stall_frac),
                "rx_q_max_chunks": self.host_rx_q_max_chunks,
            },
            "trace": self.trace_summary,
        }


def _stats_from_row(cfg, stream: StreamSpec, row: dict, alloc,
                    n_messages: int) -> SweepStats:
    """Host-side assembly of one run's row of the streaming gather set."""
    H, ms, sb = cfg.n_hosts, cfg.max_slots, cfg.slot_bytes
    trace_summary = None
    if cfg.trace_on:
        seen = int(row.get("tr_ev_seen", 0))
        cap = cfg.trace.ledger_cap
        trace_summary = {
            "stride": cfg.trace.stride,
            "samples": telemetry.n_samples(cfg),
            "n_events": min(seen, cap), "n_events_seen": seen,
            "events_dropped": max(0, seen - cap), "ledger_cap": cap,
            "q_peak_bytes": int(row["tr_q_peak"]) * sb,
            "grant_out_peak_bytes": int(row["tr_go_peak"]) * sb,
            "up_q_peak_bytes": int(row["tr_uq_peak"]) * sb
            if "tr_uq_peak" in row else None,
            "host_rx_q_peak_chunks": int(row["tr_hq_peak"])
            if "tr_hq_peak" in row else None,
            "timings": None,
        }
    return SweepStats(
        protocol=cfg.protocol, stream=stream, alloc=alloc,
        n_messages=n_messages, n_complete=int(row["n_complete"]),
        hist=np.asarray(row["hist"]).reshape(stream.n_size_buckets,
                                             stream.n_buckets),
        busy_frac=float(row["busy"]) / (H * ms),
        wasted_frac=float(row["wasted"]) / (H * ms),
        uplink_busy_frac=float(row["uplink_busy"]) / (H * ms),
        q_mean_bytes=float(row["q_sum"]) / (H * ms) * sb,
        q_max_bytes=float(row["q_max"]) * sb,
        prio_drained_bytes=np.asarray(row["prio_drained"],
                                      np.int64) * sb,
        lost_chunks=int(row["lost"]),
        tor_up_busy_frac=float(row["u_busy"])
        / (cfg.fabric.n_uplinks(cfg.n_hosts) * ms)
        if cfg.fabric_on else None,
        fault_lost_chunks=int(row["f_lost"]) if cfg.faults_on else None,
        retx_chunks=int(row["retx"]) if cfg.faults_on else None,
        host_tx_busy_frac=float(row["h_tx_work"]) / (H * ms * QSCALE)
        if cfg.host_tx_on else None,
        host_tx_defer_frac=float(row["h_tx_defer"]) / (H * ms)
        if cfg.host_tx_on else None,
        host_rx_stall_frac=float(row["h_rx_stall"]) / (H * ms)
        if cfg.host_rx_on else None,
        host_rx_q_max_chunks=int(row["h_rx_q_max"])
        if cfg.host_rx_on else None,
        trace_summary=trace_summary,
    )


# =============================================================== engine ==

def run_spec(cfg, spec: SweepSpec) -> list:
    """Execute a :class:`SweepSpec`: prepare, group by static step
    parameters, step each group as one batch (chunked and streamed as
    configured), and finalize — results in input order. (Public entry
    point: ``run_sweep(cfg, spec)``.) The call is the call span
    ``sweep.call`` (:mod:`repro_torch.core.spans`); inside it
    ``sweep.prepare`` covers the tables' ``prepare``, ``sweep.step`` each
    chunk's slot loop and ``sweep.to_host`` each group's copy to the
    host."""
    with spans.span("sweep.call"):
        return _run_spec(cfg, spec)


def _run_spec(cfg, spec: SweepSpec) -> list:
    tables = spec.resolve_tables(cfg)
    if not tables:
        return []
    proto = get_protocol(cfg.protocol)
    N = len(tables)
    stream = spec.stream

    alloc = spec.alloc
    if spec.shared_alloc and alloc is None:
        alloc = allocate_priorities(
            np.concatenate([t.size for t in tables]),
            unsched_limit=cfg.rtt_bytes, n_prios=cfg.n_prios)
    allocs = list(alloc) if isinstance(alloc, (list, tuple)) \
        else [alloc] * N
    uls = list(spec.unsched_limit_bytes) \
        if isinstance(spec.unsched_limit_bytes, (list, tuple)) \
        else [spec.unsched_limit_bytes] * N
    if len(allocs) != N or len(uls) != N:
        raise ValueError("per-table alloc/unsched_limit lists must match "
                         "the number of tables")
    n = resolve_devices(spec.shard)
    rank = dist.get_rank() if n > 1 else 0
    if n > 1:
        cfg = dataclasses.replace(cfg, device=_rank_device(cfg.device,
                                                           rank))

    prepped = []
    with spans.span("sweep.prepare"):
        for t, al_i, ul_i in zip(tables, allocs, uls):
            S, al = sim.prepare(cfg, t, al_i, ul_i)
            prepped.append((S, al, proto.n_sched(cfg, al)))

    groups = list(group_runs([(len(t.size), ns) for t, (_, _, ns)
                              in zip(tables, prepped)]).items())
    # rank r's block of each group, the group padded to a multiple of n
    blocks, err = {}, None
    try:
        for g, ((_, n_sched), idxs) in enumerate(groups):
            padded = idxs + [idxs[-1]] * ((-len(idxs)) % n)
            per = len(padded) // n
            mine = padded[rank * per:(rank + 1) * per]
            if mine:
                blocks[g] = _run_block(cfg, proto, spec, prepped, tables,
                                       mine, n_sched)
    except Exception as e:      # every rank must reach the gather
        if n == 1:
            raise
        err = e
    ranks = _gather_blocks(blocks, err, n) if n > 1 else [blocks]

    results: list = [None] * N
    for g, (_, idxs) in enumerate(groups):
        rows = {key: np.concatenate([b[g][key] for b in ranks])
                for key in ranks[0][g]}
        for k, i in enumerate(idxs):        # padding rows never read
            if stream is not None:
                results[i] = _stats_from_row(
                    cfg, stream, {key: v[k] for key, v in rows.items()},
                    prepped[i][1], len(tables[i].size))
            else:
                results[i] = sim._finalize(cfg, tables[i], prepped[i][0],
                                           prepped[i][1], rows, k,
                                           spec.return_state,
                                           reduce_trace=True)
    return results


def _run_block(cfg, proto, spec: SweepSpec, prepped: list, tables: list,
               idxs: list, n_sched: int) -> dict:
    """Step runs ``idxs`` (one group's, or a rank's block of it) as one
    batch on ``cfg.device``: the host rows of the final state, or of its
    streaming summary."""
    stream = spec.stream
    with torch.cuda.device(cfg.device) \
            if torch.device(cfg.device).type == "cuda" \
            else contextlib.nullcontext():
        S = sim.stack_static([prepped[i][0] for i in idxs])
        aux = sim.stack_static([_pack_aux(stream, tables[i], cfg.device)
                                for i in idxs]) if stream else None
        st, acc = _run_batch(cfg, proto, S, aux, n_sched, spec.chunk_slots,
                             stream)
        if stream is not None:
            st = _device_summary(cfg, st, acc)
        with spans.span("sweep.to_host"):
            return sim.host_state(st)


__all__ = ["SweepSpec", "StreamSpec", "SweepStats", "run_spec",
           "group_runs", "resolve_devices", "streaming_hist",
           "streaming_percentile", "percentile_from_hist",
           "sd_bucket_edges", "bucket_mid", "DEFAULT_SIZE_EDGES"]
