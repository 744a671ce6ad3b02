"""The fault layer's spans and counters: ``slot.faults``, ``slot.recovery``
and ``faults.plan`` where the fault layer is on and nowhere else; the
per-run rewind counts by trigger, equal on every backend and to the
benchmark's plain reference; and the two per-layer metrics that read
the spans (``portbench/metrics/faults_us_per_slot.py``,
``recovery_us_per_slot.py``)."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import (FabricConfig, SimConfig, SweepSpec, fabric,
                              faults, run_sweep, spans)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import harness  # noqa: E402

FAULT_SPANS = {"slot.faults", "slot.recovery", "faults.plan"}
LOSSY = dict(up_loss=0.02, down_loss=0.01, ge_p_gb=0.005, ge_p_bg=0.1,
             link_fail=((5, 10, 60),), tor_fail=((1, 20, 40),),
             resend_slots=15, sender_timeout_slots=30, seed=3)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the process's place."""
    r = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", r)
    return r


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(routing="ecmp", fkw=None, slots=24, backend=None):
    """16 hosts in 2 racks, 2 runs of 60 W3 messages, chunks of a third
    of the run."""
    cfg = SimConfig(n_hosts=16, protocol="homa", max_slots=slots,
                    ring_cap=64, device="cpu", backend=backend,
                    fabric=FabricConfig(racks=2, up_cap=32, routing=routing,
                                        flowlet_slots=8, faults=fkw))
    spec = SweepSpec(seeds=(3, 4), workload="W3", load=0.8, n_messages=60,
                     shared_alloc=True, chunk_slots=slots // 3,
                     streaming=True)
    return cfg, spec


class Dispatched(TorchDispatchMode):
    """Counts the operations PyTorch dispatches."""
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        Dispatched.n += 1
        return func(*args, **(kwargs or {}))


def _dispatched(cfg, spec):
    Dispatched.n = 0
    with Dispatched():
        run_sweep(cfg, spec)
    return Dispatched.n


def _raise(*a, **k):
    raise AssertionError("the fault layer ran in a fault-free run")


@pytest.mark.parametrize("routing,per_slot", [("ecmp", 440),
                                              ("flowlet", 441)])
def test_fault_free_slots_run_nothing_new(routing, per_slot, rec,
                                          monkeypatch):
    """Without faults no code of the fault layer runs, and a slot
    dispatches the operations it dispatched before the fault layer had
    spans and counters (440 under ECMP, 441 under flowlets, counted on
    the tree before them)."""
    for mod, name in ((fabric, "inject_losses"), (fabric, "forward_losses"),
                      (faults, "apply_recovery"),
                      (faults, "init_fault_state")):
        monkeypatch.setattr(mod, name, _raise)
    a = _dispatched(*tiny(routing, slots=10))
    b = _dispatched(*tiny(routing, slots=20))
    assert (b - a) / 10 == per_slot


@pytest.mark.parametrize("routing", ["ecmp", "flowlet"])
def test_fault_free_sweeps_record_no_fault_span(routing, rec):
    cfg, spec = tiny(routing)
    with profile(activities=[ProfilerActivity.CPU]):
        got = run_sweep(cfg, spec)
    names = {s[1] for s in rec.records()}
    assert "slot" in names and not names & FAULT_SPANS
    for s in got:
        assert s.fault_lost_chunks is s.retx_chunks is None
        assert s.resend_rewinds is s.timeout_rewinds is None


def test_lossy_spans_in_every_traced_slot(rec):
    """Each slot holds ``slot.faults`` (the uplink choice and the first
    loss points) before its inserts, another inside ``slot.uplink`` (the
    forwarding losses) and ``slot.recovery`` last; each ``run_slots``
    call records its block's plan as ``faults.plan`` before its first
    slot."""
    cfg, spec = tiny("flowlet", LOSSY)
    with profile(activities=[ProfilerActivity.CPU]):
        run_sweep(cfg, spec)
    got = rec.records()

    def children(i):
        return [s for s in got if s[4] == i]
    slots = [s for s in got if s[1] == "slot"]
    assert len(slots) == cfg.max_slots
    for s in slots:
        kids = children(s[0])
        assert [c[1] for c in kids] == [
            "slot.grants", "slot.faults", "ring.insert", "ring.insert",
            "slot.uplink", "slot.drain", "slot.stats", "slot.recovery"]
        assert [c[1] for c in children(kids[4][0])] == ["slot.faults",
                                                        "ring.insert"]
    steps = [s for s in got if s[1] == "sweep.step"]
    assert len(steps) == 3
    for step in steps:
        kids = children(step[0])
        assert kids[0][1] == "faults.plan" and children(kids[0][0]) == []
        assert [c[1] for c in kids[1:]] == ["slot"] * (cfg.max_slots // 3)


def test_unprofiled_lossy_sweeps_record_the_plans_only(rec):
    cfg, spec = tiny("flowlet", LOSSY)
    run_sweep(cfg, spec)
    assert [s[1] for s in rec.records()].count("faults.plan") == 3
    assert not {s[1] for s in rec.records()} & {"slot.faults",
                                                "slot.recovery"}


def _lossy_sweep(backend, device="cpu"):
    """The lossy cell cut to 16 hosts in 2 racks, 150 slots and 4 runs of
    60 messages, through the port on ``backend``, and the benchmark
    reference's rows of its runs."""
    p = harness.plan(harness.load_benchmark(), "homa144-lossy-w3-b320")
    config = dict(p.config, n_hosts=16, max_slots=150, ring_cap=64)
    config["fabric"] = dict(config["fabric"], racks=2, up_cap=32,
                            flowlet_slots=8, faults=LOSSY)
    mix = dict(p.traffic, loads=[0.6, 0.9], seeds_per_load=2,
               n_messages=60, chunk_slots=50)
    tables = p.generator.tables(mix, config, 17)
    cfg, spec = p.runner.program(config, tables, mix, device)
    got = run_sweep(dataclasses.replace(cfg, backend=backend), spec)
    want = p.reference.run(config, tables, mix["streaming"],
                           mix["chunk_slots"], True,
                           list(range(len(tables))), device)
    return got, want


def _counts(got):
    return [(s.resend_rewinds, s.timeout_rewinds, s.retx_chunks,
             s.fault_lost_chunks) for s in got]


def test_rewind_counts_equal_on_every_backend_and_the_reference(
        one_thread):
    plain, want = _lossy_sweep("reference")
    fused, _ = _lossy_sweep("fused")
    assert _counts(plain) == _counts(fused) == [
        (int(w["rw_resend"]), int(w["rw_timeout"]), int(w["retx"]),
         int(w["f_lost"])) for w in want]
    assert sum(c[0] for c in _counts(plain)) > 0
    assert sum(c[1] for c in _counts(plain)) > 0


@pytest.mark.gpu
def test_rewind_counts_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: backend cuda runs only there")
    got, want = _lossy_sweep("cuda", "cuda")
    assert _counts(got) == [
        (int(w["rw_resend"]), int(w["rw_timeout"]), int(w["retx"]),
         int(w["f_lost"])) for w in want]


# ----------------------------------------------- the per-layer metrics --

US = 1000                                   # ns
METRICS = ("faults_us_per_slot", "recovery_us_per_slot")


@pytest.fixture
def clocked(monkeypatch):
    """A fresh recorder on a clock the test sets."""
    r = spans.Recorder()
    clock = [0]
    monkeypatch.setattr(spans, "RECORDER", r)
    monkeypatch.setattr(spans, "now", lambda: clock[0])
    r.clock = clock
    return r


def canned(r, stages, start=0, slots=4):
    """``slots`` slots of 100 us inside one sweep step from ``start`` us,
    each with one launch in every stage of ``stages`` (a 1 us operation,
    1 us after its launch call) and one outside them."""
    clock, launches = r.clock, []
    clock[0] = start * US
    with spans.span("sweep.call"), spans.span("sweep.step"):
        for k in range(slots):
            base = start + 100 * (k + 1)
            clock[0] = base * US
            with spans.span("slot"):
                launches.append(base + 2)
                for j, name in enumerate(stages):
                    at = base + 10 + 20 * j
                    clock[0] = at * US
                    with spans.span(name):
                        launches.append(at + 1)
                        clock[0] = (at + 10) * US
                clock[0] = (base + 90) * US
    device = [("elementwise_kernel", "kernel", (t + 1) * US, (t + 2) * US)
              for t in launches]
    host = [("cudaLaunchKernel", t * US, t * US + US // 2) for t in launches]
    return {"slots": slots, "span": (device[0][2], device[-1][3]),
            "device": device, "host": host, "markers": 256}


def test_fault_metrics_read_zero_without_faults_and_more_with(clocked):
    read = {n: harness.load_module("metrics", n).read for n in METRICS}
    clean = canned(clocked, ("slot.grants", "slot.drain"))
    assert [read[n](clean) for n in METRICS] == [0.0, 0.0]
    lossy = canned(clocked, ("slot.grants", "slot.faults", "slot.faults",
                             "slot.recovery"), start=10_000)
    assert read["faults_us_per_slot"](lossy) == 2.0
    assert read["recovery_us_per_slot"](lossy) == 1.0


def test_fault_metrics_read_nothing_from_a_program_without_the_spans(
        clocked, monkeypatch):
    """A program whose spans module declares no fault spans (an older
    checkout) reads nothing, not 0.0."""
    lossy = canned(clocked, ("slot.faults", "slot.recovery"))
    monkeypatch.setattr(spans, "SLOT_SPANS", spans.SLOT_SPANS[:6])
    for n in METRICS:
        assert harness.load_module("metrics", n).read(lossy) is None
