"""Write the host-stage and telemetry golden,
``tests/golden/host_trace_enabled.json``, from the JAX package's
``simulate`` on the reference backend, on the CPU.

    PYTHONPATH=src python scripts/make_torch_host_trace_golden.py [--check]
        [--only small|full]

Two parts:

  small  16 hosts (single switch, or 4 racks 2:1 oversubscribed), W2 at
         load 0.7, 200 messages, 1500 slots: all six protocols behind
         the ``kernel_stack`` host with tracing; ``kernel_bypass`` and a
         custom host (``tx_batch`` 4 with a batch cost, an RX ring of 8
         that backpressures the downlink) on the fabric; host and
         tracing on a lossy fabric (Bernoulli loss, short recovery
         timers); tracing alone on the fabric and the lossy fabric; the
         custom host alone. Ledger capacities are small enough to
         overflow, strides do not divide the horizon, and one run keeps
         no ledger. Each run records every array of the loop state of at
         most 1024 elements, a digest of every array
         (``repro_torch.core.results.state_digests``), the recorded
         ledger rows, the trace's scalars and the host summary.
         ``tests/test_torch_golden_host_trace.py`` replays it through
         the port on the CPU.
  full   the paper's 144-host, 9-rack full-bisection fabric, W3 at load
         0.4 with 8000 messages, homa behind ``kernel_stack`` with
         ``TraceConfig(stride=16, ledger_cap=4096)``, stepped 4000
         slots: the completions, the chunk counters and a digest of
         every array of the loop state. ``chip_smoke.py`` phase 10b
         holds the port's state to it on the card.

``--check`` recomputes and exits 1 on any difference from the committed
file instead of writing it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden" / \
    "host_trace_enabled.json"
PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]
LIST_MAX = 1024                  # larger arrays are kept as digests only

SMALL_META = dict(workload="W2", n_hosts=16, load=0.7, n_messages=200,
                  slot_bytes=256, seed=5, max_slots=1500, ring_cap=512,
                  racks=4, oversub=2.0, up_cap=256)
CUSTOM = dict(tx_cost_slots=0.5, tx_batch=4, tx_batch_cost_slots=2.0,
              tx_queue_cap=4, rx_cost_slots=1.5, rx_queue_cap=8)
LOSSY = dict(up_loss=0.02, down_loss=0.01, ge_p_gb=0.005, ge_p_bg=0.1,
             ge_loss=0.5, resend_slots=60, sender_timeout_slots=150, seed=3)
# (name, protocol, topology, host, trace); topology is "switch",
# "fabric" or "lossy"
SMALL_RUNS = (
    [(f"{p}-kstack-switch", p, "switch", "kernel_stack",
      dict(stride=48, ledger_cap=384)) for p in PROTOS]
    + [("homa-bypass-fabric", "homa", "fabric", "kernel_bypass",
        dict(stride=16, ledger_cap=512)),
       ("homa-custom-fabric", "homa", "fabric", CUSTOM,
        dict(stride=37, ledger_cap=256)),
       ("basic-custom-switch", "basic", "switch", CUSTOM, None),
       ("homa-kstack-lossy", "homa", "lossy", "kernel_stack",
        dict(stride=32, ledger_cap=512)),
       ("pias-bypass-lossy", "pias", "lossy", "kernel_bypass",
        dict(stride=50, ledger_cap=0)),
       ("phost-trace-lossy", "phost", "lossy", None,
        dict(stride=64, ledger_cap=512)),
       ("ndp-trace-fabric", "ndp", "fabric", None,
        dict(stride=100, ledger_cap=384))])

FULL_META = dict(workload="W3", n_hosts=144, load=0.4, n_messages=8000,
                 slot_bytes=256, seed=0, slots=4000, ring_cap=1024,
                 racks=9, oversub=1.0, up_cap=512, protocol="homa",
                 host="kernel_stack")
FULL_TRACE = dict(stride=16, ledger_cap=4096)


def small_fabric(meta, topology):
    """The ``FabricConfig`` keyword arguments of a small run's topology
    (``None`` for the single switch)."""
    if topology == "switch":
        return None
    fab = dict(racks=meta["racks"], oversub=meta["oversub"],
               up_cap=meta["up_cap"])
    if topology == "lossy":
        fab["faults"] = dict(LOSSY)
    return fab


def record(r, state) -> dict:
    """The golden's fields of one run: ``r`` a ``SimResult`` of either
    package, ``state`` its loop state as numpy arrays (no run axis),
    less the port's per-run rewind counts, which the JAX package's state
    does not carry."""
    from repro_torch.core.faults import REWIND_KEYS
    from repro_torch.core.results import state_digests
    import numpy as np
    state = {k: v for k, v in state.items() if k not in REWIND_KEYS}
    out = {"n_complete": int(r.n_complete),
           "lost_chunks": int(r.lost_chunks),
           "arrays": {k: np.asarray(v).tolist()
                      for k, v in sorted(state.items())
                      if np.asarray(v).size <= LIST_MAX
                      and np.asarray(v).dtype.kind != "f"},
           "digests": state_digests(state),
           "host": r.summary()["host"],
           "trace": None}
    if r.trace is not None:
        t = r.trace
        out["trace"] = {k: v for k, v in t.reduce().items()
                        if k != "timings"}
        out["events"] = t.events.tolist()
        out["perfetto_events"] = len(t.to_perfetto()["traceEvents"])
    return out


def differences(run: dict, got: dict) -> list[str]:
    """The fields (and, under ``digests``, the state keys) in which
    ``got`` (:func:`record` of a replay) differs from the golden's
    ``run``."""
    got = json.loads(json.dumps(got))
    want = {k: v for k, v in run.items()
            if k not in ("name", "protocol", "topology", "host_cfg",
                         "trace_cfg")}
    bad = sorted(k for k in want if got.get(k) != want[k])
    if "digests" in bad:
        bad += sorted(k for k in want["digests"]
                      if got["digests"].get(k) != want["digests"][k])
    return bad


def _small() -> dict:
    import numpy as np
    from repro.core import (FabricConfig, SimConfig, TraceConfig,
                            make_messages, simulate)
    m = SMALL_META
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"], seed=m["seed"])
    runs = []
    for name, proto, topology, host, trace in SMALL_RUNS:
        fab = small_fabric(m, topology)
        cfg = SimConfig(protocol=proto, n_hosts=m["n_hosts"],
                        max_slots=m["max_slots"], ring_cap=m["ring_cap"],
                        fabric=None if fab is None else FabricConfig(**fab),
                        host=host,
                        trace=None if trace is None else TraceConfig(**trace),
                        backend="reference")
        r = simulate(cfg, tbl, return_state=True)
        st = {k: np.asarray(v) for k, v in r.state.items()}
        runs.append({"name": name, "protocol": proto, "topology": topology,
                     "host_cfg": host, "trace_cfg": trace,
                     **record(r, st)})
        seen = runs[-1]["trace"] and runs[-1]["trace"]["n_events_seen"]
        print(f"# small {name}: {int(r.n_complete)}/{r.n_messages} done, "
              f"events {seen}, rx stall "
              f"{int(st.get('h_rx_stall', np.zeros(1)).sum())}",
              file=sys.stderr)
    return {"meta": m, "custom": CUSTOM, "lossy": LOSSY, "runs": runs}


def full_counters(st: dict) -> dict:
    """The run's chunk counters; with the RX ring, conservation reads
    ``sent == recv + r_valid + u_valid + lost + u_lost + (h_rx_tail -
    h_rx_head)``."""
    out = {k: int(st[k].sum()) for k in ("sent", "recv", "r_valid",
                                         "u_valid", "lost", "u_lost",
                                         "h_tx_defer", "h_rx_stall")}
    out["rx_ring"] = int((st["h_rx_tail"] - st["h_rx_head"]).sum())
    out["events_seen"] = int(st["tr_ev_n"])
    return out


def _full() -> dict:
    import numpy as np
    from repro.core import (FabricConfig, SimConfig, TraceConfig,
                            make_messages, simulate)
    from repro_torch.core.results import state_digests
    m = FULL_META
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"], seed=m["seed"])
    cfg = SimConfig(protocol=m["protocol"], n_hosts=m["n_hosts"],
                    max_slots=m["slots"], ring_cap=m["ring_cap"],
                    fabric=FabricConfig(racks=m["racks"],
                                        oversub=m["oversub"],
                                        up_cap=m["up_cap"]),
                    host=m["host"], trace=TraceConfig(**FULL_TRACE),
                    backend="reference")
    t0 = time.perf_counter()
    st = simulate(cfg, tbl, return_state=True).state
    st = {k: np.asarray(v) for k, v in st.items()}
    print(f"# full: {m['slots']} slots in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return {"meta": m, "trace": FULL_TRACE,
            "completion": [int(x) for x in st["completion"]],
            "counters": full_counters(st),
            "digests": state_digests(st)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the committed file")
    ap.add_argument("--only", choices=("small", "full"),
                    help="recompute one part (the other is kept)")
    args = ap.parse_args(argv)
    old = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {}
    new = dict(old)
    for part, fn in (("small", _small), ("full", _full)):
        if args.only in (None, part):
            new[part] = fn()
    if args.check:
        bad = [p for p in ("small", "full")
               if args.only in (None, p)
               and json.loads(json.dumps(new[p])) != old.get(p)]
        if bad:
            print(f"DRIFT: {bad} differ from {GOLDEN}", file=sys.stderr)
            return 1
        print(f"OK: {GOLDEN.name} matches", file=sys.stderr)
        return 0
    GOLDEN.write_text(json.dumps(new, separators=(",", ":")) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
