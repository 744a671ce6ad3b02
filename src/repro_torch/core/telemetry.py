"""In-loop telemetry and trace capture (DESIGN.md §8); the port of
``repro.core.telemetry``.

A :class:`TraceConfig` hung off ``SimConfig.trace`` threads bounded
accumulators through the slot loop and post-processes them into a
:class:`SimTrace` attached to the result. Three planes:

**1. Strided time series.** Every ``stride`` slots (at the end of each
window, plus the final slot) the loop writes one row: instantaneous
queue occupancy (per-host downlink, per-uplink TOR, per-host RX ring)
and the cumulative counters (downlink busy/wasted, uplink busy,
per-priority drains of both tiers, outstanding grants per receiver).
The row index is computed on the device from the slot counter, so the
loop never branches in Python on the slot: off a window's end the row
is rewritten with its own value.

**2. Protocol event ledger.** A fixed ``(ledger_cap, 5)`` int32 table of
``(slot, kind, msg, host, value)`` rows per run: grants (``EV_GRANT``),
preemptions (``EV_PREEMPT``), fault losses (``EV_LOSS``), ring-overflow
drops (``EV_OVERFLOW``, msg/host -1), RESEND and timeout rewinds
(``EV_RESEND`` / ``EV_TIMEOUT``, from the ``faults.apply_recovery``
tap) and completions (``EV_COMPLETE``). Candidates take consecutive
rows in the JAX package's order (an int32 cumsum per run); rows past
the capacity fall off while ``tr_ev_n`` keeps counting, so the ledger
is bit-identical to the JAX package's.

**3. Host wall-clock.** ``TraceConfig(wallclock=True)`` makes
``simulate`` report ``SimTrace.timings`` with the JAX package's keys;
the port reads them from ``simulate``'s call spans
(:mod:`repro_torch.core.spans`); their meanings are in :func:`timings`.

``SimConfig.trace=None`` and ``TraceConfig(enabled=False)`` keep the
loop free of every tensor and operation defined here. ``run_sweep``
reduces a captured trace to scalars (:func:`reduce_state`,
:meth:`SimTrace.reduce`). Exporters: :meth:`SimTrace.to_perfetto`
(Chrome trace-event JSON) and :meth:`SimTrace.to_timeseries_json`.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.protocols import I32, grant_preempted
from repro_torch.core.scatter import set_drop

# ------------------------------------------------------------ event kinds --

EV_GRANT = 0       # receiver granted / raised a message's grant (value=slots)
EV_PREEMPT = 1     # incomplete msg evicted from the active set (value=remain)
EV_LOSS = 2        # fault-injected chunk drops on a message (value=chunks)
EV_OVERFLOW = 3    # ring-overflow drops, either tier (msg=host=-1, value=n)
EV_RESEND = 4      # receiver RESEND rewound the sender (value=chunks)
EV_TIMEOUT = 5     # sender fallback timeout rewound (value=chunks)
EV_COMPLETE = 6    # message completed (value=elapsed slots)

EV_NAMES = {EV_GRANT: "grant", EV_PREEMPT: "preempt", EV_LOSS: "loss",
            EV_OVERFLOW: "overflow", EV_RESEND: "resend",
            EV_TIMEOUT: "timeout", EV_COMPLETE: "complete"}
EV_COLUMNS = ("slot", "kind", "msg", "host", "value")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Telemetry capture parameters (frozen, hashable).
    ``TraceConfig(enabled=False)`` is the disabled sentinel, identical
    to ``SimConfig.trace=None``."""
    enabled: bool = True
    stride: int = 16                # slots per time-series sample window
    ledger_cap: int = 4096          # event rows kept; 0 disables the ledger
    wallclock: bool = False         # host set-up / build / execute split
    wallclock_repeats: int = 1      # execute N times, report the min

    def validate(self) -> None:
        if self.stride < 1:
            raise ValueError(f"TraceConfig.stride must be >= 1, got "
                             f"{self.stride}")
        if self.ledger_cap < 0:
            raise ValueError(f"TraceConfig.ledger_cap must be >= 0, got "
                             f"{self.ledger_cap}")
        if self.wallclock_repeats < 1:
            raise ValueError(f"TraceConfig.wallclock_repeats must be "
                             f">= 1, got {self.wallclock_repeats}")


def as_trace_config(trace) -> TraceConfig | None:
    """Normalize ``SimConfig.trace``: TraceConfig | dict | None."""
    if trace is None or isinstance(trace, TraceConfig):
        return trace
    if isinstance(trace, dict):
        return TraceConfig(**trace)
    raise TypeError(f"SimConfig.trace must be a TraceConfig, dict, or "
                    f"None — got {type(trace).__name__}")


def n_samples(cfg) -> int:
    """Time-series rows of a run: one per full or partial stride window."""
    return -(-cfg.max_slots // cfg.trace.stride)


# ------------------------------------------------------------- loop state --

def init_trace_state(cfg, M: int, B: int = 1) -> dict:
    """Telemetry state of B runs; only trace-enabled configs carry it."""
    tr = cfg.trace
    T, H, P = n_samples(cfg), cfg.n_hosts, cfg.n_prios
    dev = cfg.device

    def z(*shape):
        return torch.zeros((B, *shape), dtype=I32, device=dev)

    st = {
        "tr_q": z(T, H),             # instantaneous downlink queue (chunks)
        "tr_grant_out": z(T, H),     # outstanding granted-not-received slots
        "tr_busy": z(T),             # cumulative downlink-busy slot count
        "tr_wasted": z(T),           # cumulative idle-but-withheld count
        "tr_upbusy": z(T),           # cumulative sender-uplink busy count
        "tr_prio": z(T, P),          # cumulative downlink drains per level
        "tr_active": torch.zeros((B, M), dtype=torch.bool, device=dev),
    }
    if cfg.fabric_on:
        U = cfg.fabric.n_uplinks_total(cfg.n_hosts)
        st["tr_uq"] = z(T, U)        # instantaneous TOR uplink queues
        st["tr_uprio"] = z(T, P)     # cumulative uplink drains per level
        st["tr_uprio_c"] = z(P)      # running counter (fabric.uplink_drain)
    if cfg.host_rx_on:
        st["tr_hq"] = z(T, H)        # instantaneous host RX-ring backlog
    if tr.ledger_cap > 0:
        st["tr_ev"] = torch.full((B, tr.ledger_cap, 5), -1, dtype=I32,
                                 device=dev)
        st["tr_ev_n"] = z()          # total events SEEN (incl. dropped)
        if cfg.faults_on:
            st["tr_resend"] = z(M)   # chunks rewound by receiver RESEND
            st["tr_timeout"] = z(M)  # chunks rewound by sender timeout
    return st


def snapshot(cfg, st) -> dict:
    """Slot-start references needed to difference per-slot event deltas.
    No state tensor is written in place but the four ring buffers of each
    tier, which ``fabric.ring_insert`` updates in place on the kernel
    backends; this holds none of them, so it copies nothing."""
    prev = {"grant_r": st["grant_r"], "completion": st["completion"],
            "lost": st["lost"]}
    if cfg.fabric_on:
        prev["u_lost"] = st["u_lost"]
    if cfg.faults_on:
        prev["msg_lost"] = st["msg_lost"]
    return prev


def _append_events(cfg, st, mask, kind, msg, host, value, now):
    """Masked bulk append into each run's fixed ledger: every masked
    candidate takes the next free row of its run; candidates past the
    capacity are dropped and only the seen counter keeps growing."""
    E = cfg.trace.ledger_cap
    mi = mask.to(I32)                                       # (B, N)
    pos = st["tr_ev_n"][:, None] + torch.cumsum(mi, dim=1, dtype=I32) - mi
    keep = mask & (pos < E)
    rows = torch.stack([now.expand(kind.shape), kind, msg, host, value],
                       dim=2)                               # (B, N, 5)
    cols = torch.arange(5, dtype=I32, device=pos.device)
    idx = (pos[:, :, None] * 5 + cols).flatten(1)
    B = mask.shape[0]
    return {**st,
            "tr_ev": set_drop(st["tr_ev"], idx, rows.reshape(B, -1),
                              keep[:, :, None].expand(rows.shape)
                              .reshape(B, -1)),
            "tr_ev_n": st["tr_ev_n"] + mi.sum(dim=1, dtype=I32)}


def _slot_events(cfg, st, S, now, prev, active):
    """Collect this slot's protocol events into the ledger, candidates in
    the JAX package's order."""
    dst, msg_ids = S["dst"], S["msg_ids"]
    B = dst.shape[0]

    def cand(mask, kind, value, msg=msg_ids, host=dst):
        return (mask, torch.full(mask.shape, kind, dtype=I32,
                                 device=mask.device), msg, host, value)

    cands = [
        cand(st["grant_r"] > prev["grant_r"], EV_GRANT, st["grant_r"]),
        cand(grant_preempted(st["tr_active"], active, st["completion"]),
             EV_PREEMPT, (S["size"] - st["recv"]).clamp_min(0)),
    ]
    if cfg.faults_on:
        lost_d = st["msg_lost"] - prev["msg_lost"]
        cands.append(cand(lost_d > 0, EV_LOSS, lost_d))
        cands.append(cand(st["tr_resend"] > 0, EV_RESEND, st["tr_resend"]))
        cands.append(cand(st["tr_timeout"] > 0, EV_TIMEOUT,
                          st["tr_timeout"]))
    # ring-overflow drops have no message attribution: one row per run
    over_d = st["lost"] - prev["lost"]
    if cfg.fabric_on:
        over_d = over_d + st["u_lost"] - prev["u_lost"]
    neg1 = torch.full((B, 1), -1, dtype=I32, device=dst.device)
    cands.append(cand((over_d > 0)[:, None], EV_OVERFLOW, over_d[:, None],
                      msg=neg1, host=neg1))
    cands.append(cand(st["completion"] == now, EV_COMPLETE,
                      now - S["arrival"] + 1))

    mask, kind, msg, host, value = (torch.cat([c[i] for c in cands], dim=1)
                                    for i in range(5))
    return _append_events(cfg, st, mask, kind, msg, host, value, now)


def _write_row(series, row, do, val):
    """``series[:, row] = val`` where ``do``, else unchanged: off a
    window's end the row (clamped into range) is rewritten with its own
    value, so the slot index never leaves the device."""
    old = series.index_select(1, row)
    new = torch.where(do, val.unsqueeze(1), old)
    return series.index_copy(1, row, new)


def capture_slot(cfg, st, S, now, prev, active, qlen):
    """End-of-slot telemetry hook (called by ``sim.step_fn`` only when
    ``cfg.trace_on``): append this slot's events, then, at a window's
    end, write one strided time-series row."""
    tr = cfg.trace
    T, H = n_samples(cfg), cfg.n_hosts

    if tr.ledger_cap > 0:
        st = _slot_events(cfg, st, S, now, prev, active)
    st = {**st, "tr_active": active}

    # sample at each window's END (cumulative diffs = exact window rates);
    # when sampling, now // stride <= T - 1, so the clamp only moves the
    # rewrite of a row that is left unchanged
    stride = tr.stride
    do = (now % stride == stride - 1) | (now == cfg.max_slots - 1)
    row = (now // stride).clamp_max(T - 1).long().view(1)
    outstanding = torch.where(
        st["completion"] < 0, (st["grant_r"] - st["recv"]).clamp_min(0), 0)
    grant_out = torch.zeros((outstanding.shape[0], H), dtype=I32,
                            device=outstanding.device).scatter_add_(
        1, S["dst"].long(), outstanding)
    vals = {
        "tr_q": qlen,
        "tr_grant_out": grant_out,
        "tr_busy": st["busy"].sum(dim=1, dtype=I32),
        "tr_wasted": st["wasted"].sum(dim=1, dtype=I32),
        "tr_upbusy": st["uplink_busy"].sum(dim=1, dtype=I32),
        "tr_prio": st["prio_drained"],
    }
    if cfg.fabric_on:
        vals["tr_uq"] = st["u_valid"].sum(dim=2, dtype=I32)
        vals["tr_uprio"] = st["tr_uprio_c"]
    if cfg.host_rx_on:
        vals["tr_hq"] = st["h_rx_tail"] - st["h_rx_head"]
    return {**st, **{k: _write_row(st[k], row, do, v)
                     for k, v in vals.items()}}


# --------------------------------------------------------------- SimTrace --

@dataclasses.dataclass
class SimTrace:
    """One run's captured telemetry, post-processed to numpy.

    Cumulative series (``*_cum``) snapshot the loop's running counters at
    each sample slot; the windowed accessors difference them into exact
    per-window rates. ``events`` is the ledger's recorded prefix (slot
    order); ``n_events_seen`` counts every event observed including the
    ``events_dropped`` that fell off a full ledger.
    """
    stride: int
    slot_bytes: int
    n_hosts: int
    max_slots: int
    sample_slots: np.ndarray             # (T,) end slot of each window
    q_bytes: np.ndarray                  # (T, H) downlink queue bytes
    grant_out_bytes: np.ndarray          # (T, H) granted-not-received bytes
    busy_cum: np.ndarray                 # (T,) downlink busy slots (all hosts)
    wasted_cum: np.ndarray               # (T,)
    uplink_busy_cum: np.ndarray          # (T,) sender-NIC busy slots
    prio_drained_cum_bytes: np.ndarray   # (T, P) downlink drains per level
    up_q_bytes: np.ndarray | None        # (T, U) TOR uplink queue bytes
    up_prio_drained_cum_bytes: np.ndarray | None   # (T, P)
    events: np.ndarray                   # (n, 5) int32, EV_COLUMNS order
    ledger_cap: int
    n_events_seen: int
    timings: dict | None = None          # wallclock=True: timings()
    host_rx_q_chunks: np.ndarray | None = None   # (T, H) host RX backlog

    # ------------------------------------------------------------ derived

    @property
    def n_events(self) -> int:
        return int(self.events.shape[0])

    @property
    def events_dropped(self) -> int:
        return max(0, self.n_events_seen - self.n_events)

    def _widths(self) -> np.ndarray:
        return np.diff(self.sample_slots, prepend=-1)

    def busy_frac(self) -> np.ndarray:
        """(T,) windowed downlink busy fraction (all hosts pooled)."""
        return np.diff(self.busy_cum, prepend=0) \
            / (self._widths() * self.n_hosts)

    def wasted_frac(self) -> np.ndarray:
        return np.diff(self.wasted_cum, prepend=0) \
            / (self._widths() * self.n_hosts)

    def uplink_busy_frac(self) -> np.ndarray:
        return np.diff(self.uplink_busy_cum, prepend=0) \
            / (self._widths() * self.n_hosts)

    def prio_usage(self, tier: str = "down") -> np.ndarray:
        """(T, P) per-window drained bytes per priority level (the paper's
        Fig. 13 view over time). ``tier`` is "down" or (fabric) "up"."""
        cum = self.prio_drained_cum_bytes if tier == "down" \
            else self.up_prio_drained_cum_bytes
        if cum is None:
            raise ValueError(f"no {tier!r}-tier priority series captured")
        return np.diff(cum, prepend=0, axis=0)

    def events_of(self, kind: int) -> np.ndarray:
        return self.events[self.events[:, 1] == kind]

    # ------------------------------------------------------------ reduce

    def reduce(self) -> dict:
        """Streaming-stat scalars (all that sweeps keep)."""
        return {
            "stride": self.stride,
            "samples": int(len(self.sample_slots)),
            "n_events": self.n_events,
            "n_events_seen": int(self.n_events_seen),
            "events_dropped": self.events_dropped,
            "ledger_cap": self.ledger_cap,
            "q_peak_bytes": int(self.q_bytes.max()) if self.q_bytes.size
            else 0,
            "grant_out_peak_bytes": int(self.grant_out_bytes.max())
            if self.grant_out_bytes.size else 0,
            "up_q_peak_bytes": int(self.up_q_bytes.max())
            if self.up_q_bytes is not None and self.up_q_bytes.size else None,
            "host_rx_q_peak_chunks": int(self.host_rx_q_chunks.max())
            if self.host_rx_q_chunks is not None
            and self.host_rx_q_chunks.size else None,
            "timings": self.timings,
        }

    # --------------------------------------------------------- exporters

    def to_timeseries_json(self) -> dict:
        """JSON-safe time-series dict."""
        out = {
            "stride": self.stride, "slot_bytes": self.slot_bytes,
            "n_hosts": self.n_hosts, "max_slots": self.max_slots,
            "sample_slots": self.sample_slots.tolist(),
            "q_bytes": self.q_bytes.tolist(),
            "grant_out_bytes": self.grant_out_bytes.tolist(),
            "busy_frac": np.round(self.busy_frac(), 6).tolist(),
            "wasted_frac": np.round(self.wasted_frac(), 6).tolist(),
            "uplink_busy_frac":
                np.round(self.uplink_busy_frac(), 6).tolist(),
            "prio_drained_bytes": self.prio_usage("down").tolist(),
            "events": {"columns": list(EV_COLUMNS),
                       "rows": self.events.tolist(),
                       "kinds": {v: k for k, v in EV_NAMES.items()},
                       "n_seen": int(self.n_events_seen),
                       "dropped": self.events_dropped},
            "timings": self.timings,
        }
        if self.up_q_bytes is not None:
            out["up_q_bytes"] = self.up_q_bytes.tolist()
            out["up_prio_drained_bytes"] = self.prio_usage("up").tolist()
        if self.host_rx_q_chunks is not None:
            out["host_rx_q_chunks"] = self.host_rx_q_chunks.tolist()
        return out

    def to_perfetto(self, path=None) -> dict:
        """Chrome trace-event / Perfetto JSON. One slot maps to one
        microsecond of trace time. Counter tracks carry the strided
        series; ledger rows become instant events on per-host tracks;
        completions also become duration ("X") slices spanning
        arrival to completion."""
        ev: list[dict] = []

        def meta(pid, name):
            ev.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})

        meta(0, "time series")
        meta(1, "protocol events")
        meta(2, "messages")

        P = self.prio_drained_cum_bytes.shape[1]
        prio = self.prio_usage("down")
        for k, t in enumerate(self.sample_slots.tolist()):
            ev.append({"ph": "C", "pid": 0, "tid": 0, "ts": t,
                       "name": "downlink_q_bytes",
                       "args": {f"h{h}": int(self.q_bytes[k, h])
                                for h in range(self.n_hosts)}})
            ev.append({"ph": "C", "pid": 0, "tid": 0, "ts": t,
                       "name": "grant_outstanding_bytes",
                       "args": {f"h{h}": int(self.grant_out_bytes[k, h])
                                for h in range(self.n_hosts)}})
            ev.append({"ph": "C", "pid": 0, "tid": 0, "ts": t,
                       "name": "prio_drained_bytes",
                       "args": {f"p{p}": int(prio[k, p])
                                for p in range(P)}})
            if self.up_q_bytes is not None:
                ev.append({"ph": "C", "pid": 0, "tid": 0, "ts": t,
                           "name": "tor_uplink_q_bytes",
                           "args": {f"u{u}": int(self.up_q_bytes[k, u])
                                    for u in
                                    range(self.up_q_bytes.shape[1])}})
            if self.host_rx_q_chunks is not None:
                ev.append({"ph": "C", "pid": 0, "tid": 0, "ts": t,
                           "name": "host_rx_q_chunks",
                           "args":
                           {f"h{h}": int(self.host_rx_q_chunks[k, h])
                            for h in range(self.n_hosts)}})

        for slot, kind, msg, host, value in self.events.tolist():
            ev.append({"ph": "i", "s": "t", "pid": 1,
                       "tid": int(max(host, 0)), "ts": int(slot),
                       "name": EV_NAMES.get(int(kind), f"kind{kind}"),
                       "args": {"msg": int(msg), "value": int(value)}})
            if kind == EV_COMPLETE:
                ev.append({"ph": "X", "pid": 2, "tid": int(max(host, 0)),
                           "ts": int(slot) - int(value) + 1,
                           "dur": int(value), "name": f"msg{int(msg)}",
                           "args": {"elapsed_slots": int(value)}})

        doc = {"displayTimeUnit": "ms", "traceEvents": ev,
               "otherData": {"slot_bytes": self.slot_bytes,
                             "stride": self.stride,
                             "events_dropped": self.events_dropped}}
        if path is not None:
            from pathlib import Path
            Path(path).write_text(json.dumps(doc))
        return doc


def finalize_trace(cfg, st: dict, timings: dict | None = None) -> SimTrace:
    """Build a :class:`SimTrace` from one run's final state (numpy, no
    run axis)."""
    tr = cfg.trace
    T = n_samples(cfg)
    sb = cfg.slot_bytes
    sample_slots = np.minimum(np.arange(1, T + 1) * tr.stride - 1,
                              cfg.max_slots - 1).astype(np.int64)
    if tr.ledger_cap > 0:
        seen = int(st["tr_ev_n"])
        n = min(seen, tr.ledger_cap)
        events = np.asarray(st["tr_ev"][:n]).astype(np.int32)
    else:
        seen = 0
        events = np.zeros((0, 5), np.int32)
    return SimTrace(
        stride=tr.stride, slot_bytes=sb, n_hosts=cfg.n_hosts,
        max_slots=cfg.max_slots, sample_slots=sample_slots,
        q_bytes=np.asarray(st["tr_q"]) * sb,
        grant_out_bytes=np.asarray(st["tr_grant_out"]) * sb,
        busy_cum=np.asarray(st["tr_busy"]),
        wasted_cum=np.asarray(st["tr_wasted"]),
        uplink_busy_cum=np.asarray(st["tr_upbusy"]),
        prio_drained_cum_bytes=np.asarray(st["tr_prio"]) * sb,
        up_q_bytes=np.asarray(st["tr_uq"]) * sb if cfg.fabric_on else None,
        up_prio_drained_cum_bytes=np.asarray(st["tr_uprio"]) * sb
        if cfg.fabric_on else None,
        events=events, ledger_cap=tr.ledger_cap, n_events_seen=seen,
        timings=timings,
        host_rx_q_chunks=np.asarray(st["tr_hq"]) if cfg.host_rx_on
        else None,
    )


def reduce_state(cfg, st: dict) -> dict:
    """On-device trace reduction for streaming sweeps (DESIGN.md §9): the
    :meth:`SimTrace.reduce` peaks and counts of B runs, ``(B,)`` each, so
    a sweep copies a handful of scalars per run instead of the ``(T, H)``
    series. Chunked runs give the same values: rows are written by
    global slot."""
    def peak(k):
        return st[k].flatten(1).amax(dim=1)

    out = {"tr_q_peak": peak("tr_q"), "tr_go_peak": peak("tr_grant_out")}
    if cfg.fabric_on:
        out["tr_uq_peak"] = peak("tr_uq")
    if cfg.host_rx_on:
        out["tr_hq_peak"] = peak("tr_hq")
    if cfg.ledger_on:
        out["tr_ev_seen"] = st["tr_ev_n"]
    return out


# ------------------------------------------------------------- wall clock --

def timings(prepare, load, runs) -> dict:
    """The wall-clock split of a ``simulate`` call with the JAX
    package's keys, in seconds rounded to 0.1 ms, from its call spans
    (:mod:`repro_torch.core.spans`):

      trace_s          ``simulate.prepare``: the host set-up of a run
                       (``prepare`` and the slot-0 state)
      compile_s        ``simulate.load``: building (or loading) the
                       kernel library the run launches; 0.0 once it is
                       loaded, and on the CPU
      execute_s        the shortest of the ``simulate.run`` spans, each
                       the loop from the same state between two
                       synchronizations (the loop is deterministic, so
                       repeats change only the time)
      execute_repeats  the number of ``simulate.run`` spans"""
    return {"trace_s": round(prepare.seconds, 4),
            "compile_s": round(load.seconds, 4),
            "execute_s": round(min(r.seconds for r in runs), 4),
            "execute_repeats": len(runs)}


__all__ = ["TraceConfig", "SimTrace", "as_trace_config", "init_trace_state",
           "snapshot", "capture_slot", "finalize_trace", "reduce_state",
           "timings", "n_samples",
           "EV_GRANT", "EV_PREEMPT", "EV_LOSS", "EV_OVERFLOW", "EV_RESEND",
           "EV_TIMEOUT", "EV_COMPLETE", "EV_NAMES", "EV_COLUMNS"]
