"""The port reproduces the integer fields of
``benchmarks/baselines/trace_smoke.json`` (``benchmarks/telemetry_figs.py``
``trace_smoke``: homa on 16 hosts in 4 racks at 2:1 with 1% uplink loss,
W2 at load 0.5 seed 7, 400 messages, 8000 slots, ``TraceConfig(stride=16,
ledger_cap=4096)``), and the off sentinels — ``host=None`` / ``"ideal"``
and ``trace=None`` / ``TraceConfig(enabled=False)`` — reproduce
``tests/golden/fabric_disabled.json`` and ``fabric_enabled.json`` (a few
protocols here; all six replay on the card)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (FabricConfig, SimConfig, TraceConfig,
                              make_messages, simulate)
from repro_torch.core.results import SimResult

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "baselines" / "trace_smoke.json"
INT_FIELDS = ("protocol", "n_messages", "slots", "n_complete", "n_events",
              "n_events_seen", "events_dropped", "samples", "stride",
              "perfetto_events")


def test_trace_smoke_reproduces_the_baseline():
    want = json.loads(BASELINE.read_text())[0]
    tbl = make_messages("W2", n_hosts=16, load=0.5, n_messages=400,
                        slot_bytes=256, seed=7)
    cfg = SimConfig(n_hosts=16, protocol="homa", ring_cap=1024,
                    max_slots=8000, device="cpu",
                    fabric=FabricConfig(racks=4, oversub=2.0, up_cap=2048,
                                        faults=dict(up_loss=0.01)),
                    trace=TraceConfig(stride=16, ledger_cap=4096))
    r = simulate(cfg, tbl)
    # the benchmark counts completions after a full-result JSON round trip
    r_back = SimResult.from_json(r.to_json(full=True))
    np.testing.assert_array_equal(r_back.completion, r.completion)
    tr = r.trace
    doc = json.loads(json.dumps(tr.to_perfetto()))
    got = dict(protocol="homa", n_messages=400, slots=8000,
               n_complete=r_back.n_complete, n_events=tr.n_events,
               n_events_seen=tr.n_events_seen,
               events_dropped=tr.events_dropped,
               samples=len(tr.sample_slots), stride=tr.stride,
               perfetto_events=len(doc["traceEvents"]))
    assert got == {k: want[k] for k in INT_FIELDS}


def _golden(name):
    return json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name, proto, host, trace", [
    ("fabric_disabled", "homa", "ideal", None),
    ("fabric_disabled", "pfabric", None, TraceConfig(enabled=False)),
    ("fabric_enabled", "pias", "ideal", TraceConfig(enabled=False)),
    ("fabric_enabled", "ndp", None, None),
])
def test_off_sentinels_reproduce_the_fabric_goldens(name, proto, host,
                                                    trace):
    g = _golden(name)
    meta, want = g["meta"], g["protocols"][proto]
    fab = (FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                        up_cap=meta["up_cap"])
           if name == "fabric_enabled" else None)
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    cfg = SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=fab, host=host, trace=trace, device="cpu")
    assert not (cfg.host_on or cfg.trace_on)
    r = simulate(cfg, tbl, return_state=True)
    assert not any(k.startswith(("h_", "tr_")) for k in r.state)
    assert r.trace is None and r.trace_summary is None and r.host is None
    got = {"completion": [int(x) for x in r.completion],
           "lost_chunks": int(r.lost_chunks),
           "q_max_bytes": [int(x) for x in r.q_max_bytes],
           "prio_drained_bytes": [int(x) for x in r.prio_drained_bytes],
           "busy": [round(float(x), 8) for x in r.busy_frac]}
    if fab is not None:
        got["tor_up_q_max_bytes"] = [int(x) for x in r.tor_up_q_max_bytes]
        got["tor_up_lost_chunks"] = int(r.tor_up_lost_chunks)
    assert got == want
