"""Structured simulation results (the port's copy of ``repro.core.results``).

The simulator historically returned a raw dict; :class:`SimResult` makes
the quantities every consumer recomputed by hand — slowdown percentiles,
utilization, queue stats, priority usage — first-class fields and methods,
with :meth:`SimResult.to_json` providing the JSON-safe summary the
benchmark cache stores.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any

import numpy as np


def _json_safe(v):
    """Recursively convert numpy scalars/arrays, tuples, and non-finite
    floats (NaN -> null) into strict-JSON-serializable values."""
    if isinstance(v, np.ndarray):
        return _json_safe(v.tolist())
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        v = float(v)
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


def state_digests(state: dict) -> dict:
    """``{key: sha256 hex digest}`` of one run's loop state (no run axis):
    each array read in C order as int64 (bool and integer arrays) or
    float64 (float ones), with its shape, so the JAX package's state and
    the port's compare key by key without shipping the arrays."""
    out = {}
    for k, v in sorted(state.items()):
        a = np.asarray(v)
        a = a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
        h = hashlib.sha256(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
        out[k] = h.hexdigest()
    return out


def bucketed_percentiles(size_bytes: np.ndarray, slowdown: np.ndarray,
                         done: np.ndarray, pct: float = 99.0,
                         n_buckets: int = 10) -> dict:
    """Percentile slowdown bucketed by message size (paper Figs. 8/12)."""
    ok = done & np.isfinite(slowdown)
    sizes = size_bytes[ok]
    sl = slowdown[ok]
    if len(sizes) == 0:
        # same schema as the populated case (count included) whether the
        # input was empty or merely had no finished messages
        return {"sizes": [], "p": [], "median": [], "count": []}
    order = np.argsort(sizes)
    sizes, sl = sizes[order], sl[order]
    edges = np.linspace(0, len(sizes), n_buckets + 1).astype(int)
    out = {"sizes": [], "p": [], "median": [], "count": []}
    for i in range(n_buckets):
        lo, hi = edges[i], edges[i + 1]
        if hi <= lo:
            continue
        out["sizes"].append(float(np.median(sizes[lo:hi])))
        out["p"].append(float(np.percentile(sl[lo:hi], pct)))
        out["median"].append(float(np.percentile(sl[lo:hi], 50)))
        out["count"].append(int(hi - lo))
    return out


@dataclasses.dataclass
class SimResult:
    """One simulation run, post-processed to numpy.

    Per-message arrays are aligned with the input ``MessageTable``;
    per-host arrays have shape ``(n_hosts,)``.
    """
    protocol: str
    alloc: Any                       # PriorityAllocation
    # per-message
    completion: np.ndarray           # slot of completion, -1 if unfinished
    elapsed: np.ndarray              # completion - arrival + 1, -1 if unfin.
    ideal: np.ndarray                # unloaded transmission time (slots)
    slowdown: np.ndarray             # elapsed / ideal, NaN if unfinished
    done: np.ndarray                 # bool
    size_slots: np.ndarray
    size_bytes: np.ndarray
    # per-host utilization
    busy_frac: np.ndarray            # downlink busy fraction
    wasted_frac: np.ndarray          # idle-but-withheld fraction (Fig. 16)
    uplink_busy_frac: np.ndarray
    # queue + priority stats
    q_mean_bytes: np.ndarray
    q_max_bytes: np.ndarray
    prio_drained_bytes: np.ndarray   # (n_prios,) bytes drained per level
    # scalars
    lost_chunks: int                 # all tiers (downlink + TOR uplink)
    n_complete: int
    n_messages: int
    # leaf-spine fabric tier (None / zero when the run was single-switch)
    fabric: dict | None = None       # topology: racks/rack_size/n_uplinks/...
    tor_up_busy_frac: np.ndarray | None = None    # (U,) uplink utilization
    tor_up_q_mean_bytes: np.ndarray | None = None
    tor_up_q_max_bytes: np.ndarray | None = None
    tor_up_lost_chunks: int = 0
    # fault-injection layer (None / zero when faults were disabled):
    faults: dict | None = None       # FaultConfig echo (loss rates, windows)
    retx_chunks: np.ndarray | None = None      # (M,) rewound-chunk credits
    msg_lost_chunks: np.ndarray | None = None  # (M,) fault-dropped chunks
    recovery_slots: np.ndarray | None = None   # (M,) first loss -> done; -1
    fault_lost_chunks: int = 0       # total chunks dropped by fault injection
    # host/NIC software-overhead stage (None when SimConfig.host was off
    # or ideal — repro_torch.core.hostmodel, DESIGN.md §10); per-host (H,)
    host: dict | None = None         # HostConfig echo (model, costs, caps)
    host_tx_busy_frac: np.ndarray | None = None   # TX CPU time / horizon
    host_tx_defer_frac: np.ndarray | None = None  # slots gated w/ traffic
    host_rx_stall_frac: np.ndarray | None = None  # slots downlink stalled
    host_rx_q_mean_chunks: np.ndarray | None = None  # RX ring backlog
    host_rx_q_max_chunks: np.ndarray | None = None
    # telemetry capture (None when SimConfig.trace was off, DESIGN.md §8):
    # trace is the full SimTrace (simulate only — run_sweep keeps just
    # trace_summary, the reduced streaming-stat dict)
    trace: Any | None = None         # repro_torch.core.telemetry.SimTrace
    trace_summary: dict | None = None
    # optional raw scan state (return_state=True)
    state: dict | None = None
    static: dict | None = None

    # ------------------------------------------------------------ derived

    @property
    def completion_rate(self) -> float:
        return float(self.done.mean()) if self.n_messages else 0.0

    def steady_mask(self, warmup_frac: float = 0.1) -> np.ndarray:
        """Completion mask with the first ``warmup_frac`` of arrivals
        dropped (steady-state window)."""
        ok = self.done.copy()
        ok[:int(self.n_messages * warmup_frac)] = False
        return ok

    def percentile(self, q: float, mask: np.ndarray | None = None
                   ) -> float | None:
        """Slowdown percentile over ``mask`` (default: completed msgs)."""
        m = self.done if mask is None else mask
        m = m & np.isfinite(self.slowdown)
        if m.sum() == 0:
            return None
        return float(np.percentile(self.slowdown[m], q))

    def percentiles_by_size(self, pct: float = 99.0, n_buckets: int = 10,
                            mask: np.ndarray | None = None) -> dict:
        return bucketed_percentiles(
            self.size_bytes, self.slowdown,
            self.done if mask is None else mask, pct, n_buckets)

    # ------------------------------------------------------- serialization

    def summary(self, *, warmup_frac: float = 0.1, small_bytes: int = 1000,
                pct: float = 99.0) -> dict:
        """JSON-safe aggregate summary (the benchmark-cache schema)."""
        ok = self.steady_mask(warmup_frac)
        small = ok & (self.size_bytes < small_bytes)
        fabric = None
        if self.fabric is not None:
            fabric = {
                **self.fabric,
                "up_busy_frac": float(np.mean(self.tor_up_busy_frac)),
                "up_q_mean_bytes": float(np.mean(self.tor_up_q_mean_bytes)),
                "up_q_max_bytes": float(np.max(self.tor_up_q_max_bytes)),
                "up_lost_chunks": int(self.tor_up_lost_chunks),
            }
        faults = None
        if self.faults is not None:
            rec = self.recovery_slots
            hit = rec >= 0          # fault-affected messages that finished
            faults = {
                **{k: list(v) if isinstance(v, tuple) else v
                   for k, v in self.faults.items()},
                "fault_lost_chunks": int(self.fault_lost_chunks),
                "retx_chunks": int(np.sum(self.retx_chunks)),
                "msgs_lossy": int(np.sum(self.msg_lost_chunks > 0)),
                "recovery_mean_slots": float(np.mean(rec[hit]))
                if hit.any() else None,
                "recovery_p99_slots": float(np.percentile(rec[hit], 99))
                if hit.any() else None,
            }
        host = None
        if self.host is not None:
            host = dict(self.host)
            if self.host_tx_busy_frac is not None:
                host["tx_busy_frac"] = float(np.mean(self.host_tx_busy_frac))
                host["tx_defer_frac"] = float(
                    np.mean(self.host_tx_defer_frac))
            if self.host_rx_stall_frac is not None:
                host["rx_stall_frac"] = float(
                    np.mean(self.host_rx_stall_frac))
                host["rx_q_mean_chunks"] = float(
                    np.mean(self.host_rx_q_mean_chunks))
                host["rx_q_max_chunks"] = int(
                    np.max(self.host_rx_q_max_chunks))
        return {
            "protocol": self.protocol,
            "n_complete": int(self.n_complete),
            "n_messages": int(self.n_messages),
            "completion_rate": self.completion_rate,
            "p99_by_size": self.percentiles_by_size(pct, mask=ok),
            "busy_frac": float(np.mean(self.busy_frac)),
            "wasted_frac": float(np.mean(self.wasted_frac)),
            "uplink_busy_frac": float(np.mean(self.uplink_busy_frac)),
            "q_mean_bytes": float(np.mean(self.q_mean_bytes)),
            "q_max_bytes": float(np.max(self.q_max_bytes)),
            "prio_drained_bytes": [int(x) for x in self.prio_drained_bytes],
            "lost_chunks": int(self.lost_chunks),
            "alloc": {"n_unsched": self.alloc.n_unsched,
                      "cutoffs": list(self.alloc.cutoffs),
                      "unsched_frac": self.alloc.unsched_bytes_frac},
            "p99_small": self.percentile(pct, small),
            "p50_small": self.percentile(50, small),
            "p99_all": self.percentile(pct, ok),
            "p50_all": self.percentile(50, ok),
            "fabric": fabric,
            "faults": faults,
            "host": host,
            "trace": self.trace_summary,
        }

    # every per-message / per-host array field, with the dtype family
    # from_json restores it as (dtype identity is not part of the
    # round-trip contract; values — including NaN — are)
    _ARRAY_FIELDS = {
        "completion": np.int64, "elapsed": np.int64, "ideal": np.int64,
        "slowdown": np.float64, "done": np.bool_,
        "size_slots": np.int64, "size_bytes": np.int64,
        "busy_frac": np.float64, "wasted_frac": np.float64,
        "uplink_busy_frac": np.float64,
        "q_mean_bytes": np.float64, "q_max_bytes": np.int64,
        "prio_drained_bytes": np.int64,
        "tor_up_busy_frac": np.float64, "tor_up_q_mean_bytes": np.float64,
        "tor_up_q_max_bytes": np.int64,
        "retx_chunks": np.int64, "msg_lost_chunks": np.int64,
        "recovery_slots": np.int64,
        "host_tx_busy_frac": np.float64, "host_tx_defer_frac": np.float64,
        "host_rx_stall_frac": np.float64,
        "host_rx_q_mean_chunks": np.float64,
        "host_rx_q_max_chunks": np.int64,
    }
    _SKIP_FIELDS = ("state", "static", "trace")   # not JSON-serialized

    def to_json(self, *, full: bool = False, **kwargs) -> str:
        """JSON string of the aggregate :meth:`summary` (default), or —
        with ``full=True`` — of every array field, round-trippable
        through :meth:`from_json` (the bench-cache full-result form).
        Both are strict JSON (numpy scalars unwrapped, NaN -> null)."""
        if not full:
            return json.dumps(_json_safe(self.summary(**kwargs)))
        d = {"__simresult__": 1}
        for f in dataclasses.fields(self):
            if f.name in self._SKIP_FIELDS:
                continue
            v = getattr(self, f.name)
            if f.name == "alloc" and v is not None:
                v = {"n_prios": v.n_prios, "n_unsched": v.n_unsched,
                     "cutoffs": list(v.cutoffs),
                     "unsched_bytes_frac": v.unsched_bytes_frac}
            d[f.name] = _json_safe(v)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str | dict) -> "SimResult":
        """Rebuild a :class:`SimResult` from :meth:`to_json(full=True)
        <to_json>` output (str or already-parsed dict). Array fields come
        back as numpy (nulls in float arrays -> NaN); ``state`` /
        ``static`` / the full ``trace`` are not round-tripped."""
        d = dict(json.loads(s)) if isinstance(s, str) else dict(s)
        if not d.pop("__simresult__", None):
            raise ValueError("not a full SimResult serialization; use "
                             "to_json(full=True) to produce one")
        if isinstance(d.get("alloc"), dict):
            from repro_torch.core.priorities import PriorityAllocation
            a = d["alloc"]
            d["alloc"] = PriorityAllocation(
                n_prios=a["n_prios"], n_unsched=a["n_unsched"],
                cutoffs=tuple(a["cutoffs"]),
                unsched_bytes_frac=a["unsched_bytes_frac"])
        for name, dt in cls._ARRAY_FIELDS.items():
            if d.get(name) is not None:
                d[name] = np.asarray(d[name], dtype=dt)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
