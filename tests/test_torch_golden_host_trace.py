"""The port on the CPU reproduces the ``"small"`` part of
``tests/golden/host_trace_enabled.json`` (written by the JAX package
through ``scripts/make_torch_host_trace_golden.py``) bit-exactly: all six
protocols behind the ``kernel_stack`` host with tracing, the
``kernel_bypass`` and a backpressuring custom host, host and tracing on
a lossy fabric, and tracing alone — every array of the loop state (by
digest), the ledger rows, the trace's scalars and the host summary."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import (FabricConfig, SimConfig, TraceConfig,
                              make_messages, simulate)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "host_trace_enabled.json"
G = json.loads(GOLDEN.read_text())["small"]
_spec = importlib.util.spec_from_file_location(
    "make_torch_host_trace_golden",
    ROOT / "scripts" / "make_torch_host_trace_golden.py")
golden_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden_script)

torch.set_num_threads(1)
RUNS = {r["name"]: r for r in G["runs"]}
# the fused order (slot-start RX delivery and room gate) on the runs
# whose host ring backpressures or whose fabric loses chunks
FUSED = ("homa-custom-fabric", "basic-custom-switch", "homa-kstack-lossy",
         "pfabric-kstack-switch")


def replay(meta, run, backend="reference", device="cpu"):
    """One golden run through the port; returns the golden's fields."""
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = golden_script.small_fabric(meta, run["topology"])
    cfg = SimConfig(protocol=run["protocol"], n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=None if fab is None else FabricConfig(**fab),
                    host=run["host_cfg"],
                    trace=None if run["trace_cfg"] is None
                    else TraceConfig(**run["trace_cfg"]),
                    backend=backend, device=device)
    r = simulate(cfg, tbl, return_state=True)
    return golden_script.record(r, {k: v for k, v in r.state.items()})


def _check(run, got):
    bad = golden_script.differences(run, got)
    assert not bad, f"{run['name']}: differs from the golden in {bad}"


@pytest.mark.parametrize("name", list(RUNS))
def test_port_matches_host_trace_golden(name):
    run = RUNS[name]
    _check(run, replay(G["meta"], run))


@pytest.mark.parametrize("name", FUSED)
def test_fused_order_matches_host_trace_golden(name):
    run = RUNS[name]
    _check(run, replay(G["meta"], run, backend="fused"))


def test_golden_spans_the_stages():
    """The golden exercises what it claims: backpressure, overflowing
    ledgers, fault events, a run without a ledger, all six protocols."""
    runs = G["runs"]
    assert {r["protocol"] for r in runs} == {"homa", "basic", "phost",
                                             "pias", "pfabric", "ndp"}
    assert sum(RUNS["homa-custom-fabric"]["arrays"]["h_rx_stall"]) > 0
    assert any(r["trace"] and r["trace"]["events_dropped"] > 0
               for r in runs)
    lossy = RUNS["homa-kstack-lossy"]["events"]
    assert {2, 4, 6} <= {row[1] for row in lossy}    # loss, resend, done
    assert RUNS["pias-bypass-lossy"]["trace"]["n_events_seen"] == 0
