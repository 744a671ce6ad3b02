"""The port's in-loop telemetry (``repro_torch.core.telemetry``) against
the JAX package's (``repro.core.telemetry``), on the CPU.

Every ``tr_*`` state key and every ``SimTrace`` field equal to JAX's on
the ``reference`` and ``fused`` backends: strides that do not divide
``max_slots``, a ledger that overflows, fault events in the ledger,
``ledger_cap=0``, the fabric series only with a fabric, the host RX
backlog; tracing is pure observation; sweeps reduce the trace to the
JAX package's scalars (chunked too); the Perfetto and JSON documents
equal JAX's; the wall-clock keys are present.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import SimConfig as JConfig
from repro.core import StreamSpec as JStreamSpec
from repro.core import SweepSpec as JSweepSpec
from repro.core import TraceConfig as JTrace
from repro.core import make_messages as jmake
from repro.core import run_sweep as jrun_sweep
from repro.core import simulate as jsimulate
from repro_torch.core import (FabricConfig, SimConfig, SimTrace, StreamSpec,
                              SweepSpec, TraceConfig, make_messages,
                              run_sweep, simulate)
from repro_torch.core import telemetry
from repro_torch.core.faults import REWIND_KEYS

torch.set_num_threads(1)
SMALL = dict(n_hosts=8, max_slots=600, ring_cap=256)
FABRIC = dict(racks=4, oversub=2.0, up_cap=128)
LOSSY = dict(racks=2, oversub=2.0, up_cap=128,
             faults=dict(up_loss=0.02, down_loss=0.01, resend_slots=60,
                         sender_timeout_slots=150, seed=3))


def _table(mk, n=120, seed=4):
    return mk("W2", n_hosts=8, load=0.7, n_messages=n, slot_bytes=256,
              seed=seed)


def _pair(trace, fab=None, proto="homa", backend="reference", host=None):
    common = dict(SMALL, protocol=proto, host=host)
    got = simulate(SimConfig(**common, backend=backend, device="cpu",
                             trace=TraceConfig(**trace),
                             fabric=FabricConfig(**fab) if fab else None),
                   _table(make_messages), return_state=True)
    want = jsimulate(JConfig(**common, trace=JTrace(**trace),
                             fabric=JFabric(**fab) if fab else None),
                     _table(jmake), return_state=True)
    return got, want


def _assert_same_trace(a, b):
    for f in dataclasses.fields(SimTrace):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


CASES = {
    # stride 7 does not divide 600; 64 rows overflow
    "switch-overflow": (dict(stride=7, ledger_cap=64), None, "homa", None),
    "fabric": (dict(stride=33, ledger_cap=4096), FABRIC, "pias", None),
    "lossy": (dict(stride=16, ledger_cap=4096), LOSSY, "homa", None),
    "no-ledger": (dict(stride=50, ledger_cap=0), FABRIC, "ndp", None),
    "host-rx": (dict(stride=16, ledger_cap=512), None, "phost",
                "kernel_stack"),
}


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_matches_jax(case, backend):
    trace, fab, proto, host = CASES[case]
    got, want = _pair(trace, fab, proto, backend, host)
    ws = {k: np.asarray(v) for k, v in want.state.items()}
    # a fault layer adds the port's per-run rewind counters
    assert set(got.state) - set(REWIND_KEYS) == set(ws)
    for k in ws:
        assert got.state[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(got.state[k], ws[k], err_msg=k)
    _assert_same_trace(got.trace, want.trace)
    assert got.trace_summary == want.trace_summary
    tr = got.trace
    assert (tr.up_q_bytes is not None) == (fab is not None)
    assert (tr.host_rx_q_chunks is not None) == (host is not None)
    if case == "switch-overflow":
        assert tr.events_dropped > 0 and tr.n_events == 64
    if case == "lossy":
        kinds = set(tr.events[:, 1].tolist())
        assert {telemetry.EV_LOSS, telemetry.EV_RESEND,
                telemetry.EV_COMPLETE} <= kinds
    if case == "no-ledger":
        assert tr.n_events == 0 and "tr_ev" not in got.state


@pytest.mark.parametrize("fab", [None, LOSSY], ids=["switch", "lossy"])
def test_tracing_is_pure_observation(fab):
    kw = dict(SMALL, protocol="homa", device="cpu", host="kernel_bypass",
              fabric=FabricConfig(**fab) if fab else None)
    tbl = _table(make_messages)
    base = simulate(SimConfig(**kw), tbl, return_state=True)
    traced = simulate(SimConfig(**kw, trace=TraceConfig(stride=9)), tbl,
                      return_state=True)
    np.testing.assert_array_equal(base.completion, traced.completion)
    for k, v in base.state.items():
        np.testing.assert_array_equal(traced.state[k], v, err_msg=k)
    assert base.trace is None and traced.trace is not None


def test_run_sweep_reduces_trace_to_scalars():
    tables = [_table(make_messages, n=60, seed=s) for s in (1, 2)]
    jtables = [_table(jmake, n=60, seed=s) for s in (1, 2)]
    trace = dict(stride=32, ledger_cap=256)
    cfg = SimConfig(protocol="homa", device="cpu", trace=TraceConfig(**trace),
                    fabric=FabricConfig(**FABRIC), **SMALL)
    jcfg = JConfig(protocol="homa", trace=JTrace(**trace),
                   fabric=JFabric(**FABRIC), **SMALL)
    got = run_sweep(cfg, SweepSpec(tables=tables, chunk_slots=250))
    want = jrun_sweep(jcfg, JSweepSpec(tables=jtables, chunk_slots=250))
    for g, w in zip(got, want):
        assert g.trace is None and g.trace_summary == w.trace_summary
        assert g.trace_summary["samples"] == telemetry.n_samples(cfg)
    # streaming: the device-side reduction, flat and chunked
    flat = run_sweep(cfg, SweepSpec(tables=tables, streaming=StreamSpec()))
    chunked = run_sweep(cfg, SweepSpec(tables=tables, chunk_slots=128,
                                       streaming=StreamSpec()))
    jstream = jrun_sweep(jcfg, JSweepSpec(tables=jtables, chunk_slots=128,
                                          streaming=JStreamSpec()))
    for f, c, w, g in zip(flat, chunked, jstream, got):
        assert f.summary()["trace"] == c.summary()["trace"] \
            == w.summary()["trace"]
        s = dict(g.trace_summary, timings=None)
        assert f.trace_summary == s


def test_exports_equal_jax_documents(tmp_path):
    got, want = _pair(dict(stride=64, ledger_cap=2048), FABRIC, "homa",
                      host="kernel_stack")
    doc = got.trace.to_perfetto(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    assert doc == want.trace.to_perfetto()
    kinds = {e["ph"] for e in doc["traceEvents"]}
    assert {"M", "C", "i", "X"} <= kinds
    n_done = int((got.trace.events[:, 1] == telemetry.EV_COMPLETE).sum())
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == n_done
    ts = got.trace.to_timeseries_json()
    assert json.loads(json.dumps(ts)) == json.loads(
        json.dumps(want.trace.to_timeseries_json()))
    assert ts["host_rx_q_chunks"] and ts["up_q_bytes"]
    np.testing.assert_array_equal(got.trace.prio_usage("up"),
                                  want.trace.prio_usage("up"))


def test_wallclock_keys_present():
    keys = {"trace_s", "compile_s", "execute_s", "execute_repeats"}
    tbl = _table(make_messages, n=30)
    kw = dict(protocol="homa", n_hosts=8, max_slots=200, ring_cap=128,
              device="cpu")
    on = simulate(SimConfig(**kw, trace=TraceConfig(
        stride=16, wallclock=True, wallclock_repeats=2)), tbl)
    off = simulate(SimConfig(**kw, trace=TraceConfig(
        enabled=False, wallclock=True)), tbl)
    assert set(on.trace.timings) == keys == set(off.trace_summary["timings"])
    assert on.trace.timings["execute_repeats"] == 2
    assert on.trace.timings["compile_s"] == 0.0       # nothing to build
    assert off.trace is None
    np.testing.assert_array_equal(on.completion, off.completion)
    plain = simulate(SimConfig(**kw), tbl)
    np.testing.assert_array_equal(plain.completion, off.completion)


def test_trace_config_validation_and_coercion():
    with pytest.raises(ValueError, match="stride"):
        SimConfig(device="cpu", trace=TraceConfig(stride=0))
    with pytest.raises(ValueError, match="ledger_cap"):
        SimConfig(device="cpu", trace=TraceConfig(ledger_cap=-1))
    with pytest.raises(ValueError, match="wallclock_repeats"):
        SimConfig(device="cpu", trace=TraceConfig(wallclock_repeats=0))
    cfg = SimConfig(device="cpu", trace={"stride": 8, "ledger_cap": 0})
    assert cfg.trace == TraceConfig(stride=8, ledger_cap=0)
    assert cfg.trace_on and not cfg.ledger_on
    assert not SimConfig(device="cpu",
                         trace=TraceConfig(enabled=False)).trace_on
    assert dataclasses.asdict(TraceConfig()) == dataclasses.asdict(JTrace())
    assert telemetry.EV_NAMES == __import__(
        "repro.core.telemetry", fromlist=["EV_NAMES"]).EV_NAMES
