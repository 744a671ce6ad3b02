"""Write the fault-layer golden, ``tests/golden/faults_enabled.json``, from
the JAX package's ``simulate`` on the reference backend, on the CPU.

    PYTHONPATH=src python scripts/make_torch_fault_golden.py [--check]
        [--only small|full]

Two parts:

  small  8 hosts in 2 racks (2:1 oversubscribed), W2 at load 0.7, 250
         messages, 3000 slots, with recovery timers short enough
         (``resend_slots`` 60, ``sender_timeout_slots`` 150) that both
         fire inside the horizon: all six protocols under Bernoulli
         uplink and downlink loss with Gilbert-Elliott bursts (ECMP), and
         homa under one ``link_fail`` and one ``tor_fail`` window with
         ``ecmp``, ``flowlet`` and ``adaptive`` routing. Each run records
         completion, ``retx_chunks``, ``msg_lost_chunks``,
         ``fault_lost_chunks``, ``lost_chunks``, ``tor_up_lost_chunks``
         and the per-host busy fraction. ``tests/test_torch_golden_faults.py``
         replays it through the port on the CPU.
  full   the paper's 144-host, 9-rack full-bisection fabric, W3 at load
         0.8 with 8000 messages, homa, flowlet routing and every kind of
         fault at once, stepped 4000 slots: the completions, the fault
         counters and a digest of every array of the loop state
         (``repro_torch.core.results.state_digests``).
         ``chip_smoke.py`` phase 9b holds the port's state to it on the
         card.

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
    "faults_enabled.json"
PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]

SMALL_META = dict(workload="W2", n_hosts=8, load=0.7, n_messages=250,
                  slot_bytes=256, seed=11, max_slots=3000, ring_cap=512,
                  racks=2, oversub=2.0, up_cap=256)
TIMERS = dict(resend_slots=60, sender_timeout_slots=150)
LOSSY = dict(up_loss=0.02, down_loss=0.01, ge_p_gb=0.005, ge_p_bg=0.1,
             ge_loss=0.5, seed=3, **TIMERS)
WINDOWS = dict(link_fail=[[1, 400, 1200]], tor_fail=[[1, 800, 1400]],
               **TIMERS)
# (name, protocol, routing, faults)
SMALL_RUNS = ([(f"{p}-lossy-ecmp", p, "ecmp", LOSSY) for p in PROTOS]
              + [(f"homa-windows-{r}", "homa", r, WINDOWS)
                 for r in ("ecmp", "flowlet", "adaptive")])

FULL_META = dict(workload="W3", n_hosts=144, load=0.8, n_messages=8000,
                 slot_bytes=256, seed=0, slots=4000, ring_cap=1024,
                 racks=9, oversub=1.0, up_cap=512, routing="flowlet",
                 protocol="homa")
FULL_FAULTS = dict(up_loss=0.01, down_loss=0.002, ge_p_gb=0.001,
                   ge_p_bg=0.05, ge_loss=0.5, link_fail=[[5, 1000, 2500]],
                   tor_fail=[[3, 1500, 2000]], resend_slots=300,
                   sender_timeout_slots=760, seed=1)


def _small() -> dict:
    from repro.core import FabricConfig, SimConfig, make_messages, simulate
    m = SMALL_META
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"], seed=m["seed"])
    runs = []
    for name, proto, routing, faults in SMALL_RUNS:
        fab = FabricConfig(racks=m["racks"], oversub=m["oversub"],
                           up_cap=m["up_cap"], routing=routing,
                           faults=dict(faults))
        cfg = SimConfig(protocol=proto, n_hosts=m["n_hosts"],
                        max_slots=m["max_slots"], ring_cap=m["ring_cap"],
                        fabric=fab, backend="reference")
        r = simulate(cfg, tbl)
        runs.append({
            "name": name, "protocol": proto, "routing": routing,
            "faults": faults,
            "completion": [int(x) for x in r.completion],
            "retx_chunks": [int(x) for x in r.retx_chunks],
            "msg_lost_chunks": [int(x) for x in r.msg_lost_chunks],
            "fault_lost_chunks": int(r.fault_lost_chunks),
            "lost_chunks": int(r.lost_chunks),
            "tor_up_lost_chunks": int(r.tor_up_lost_chunks),
            "busy": [round(float(x), 8) for x in r.busy_frac]})
        print(f"# small {name}: {int(r.n_complete)}/{r.n_messages} done, "
              f"f_lost {int(r.fault_lost_chunks)}, retx "
              f"{int(r.retx_chunks.sum())}", file=sys.stderr)
    return {"meta": m, "runs": runs}


def _full() -> dict:
    import numpy as np
    from repro.core import FabricConfig, SimConfig, make_messages, simulate
    from repro_torch.core.results import state_digests
    m = FULL_META
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"], seed=m["seed"])
    fab = FabricConfig(racks=m["racks"], oversub=m["oversub"],
                       up_cap=m["up_cap"], routing=m["routing"],
                       faults=dict(FULL_FAULTS))
    cfg = SimConfig(protocol=m["protocol"], n_hosts=m["n_hosts"],
                    max_slots=m["slots"], ring_cap=m["ring_cap"],
                    fabric=fab, backend="reference")
    t0 = time.perf_counter()
    st = simulate(cfg, tbl, return_state=True).state
    st = {k: np.asarray(v) for k, v in st.items()}
    print(f"# full: {m['slots']} slots in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return {"meta": m, "faults": FULL_FAULTS,
            "completion": [int(x) for x in st["completion"]],
            "counters": full_counters(st),
            "digests": state_digests(st)}


def full_counters(st: dict) -> dict:
    """The run's chunk counters; conservation reads ``sent + retx == recv
    + r_valid + u_valid + lost + u_lost + f_lost``."""
    return {k: int(st[k].sum()) for k in ("sent", "retx", "recv",
                                          "r_valid", "u_valid", "lost",
                                          "u_lost", "f_lost", "msg_lost")}


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
               if args.only in (None, p) and new[p] != old.get(p)]
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
