"""The port's span recorder (``repro_torch.core.spans``): nesting, the
buffer's capacity, the two tiers, the clock it shares with the
profiler's records, and the tree of spans a sweep leaves."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import (FabricConfig, SimConfig, SweepSpec, run_sweep,
                              spans)

SWEEP_CALL = ["sweep.prepare", "sweep.step", "sweep.step", "sweep.step",
              "sweep.to_host"]
SLOT_STAGES = ["slot.grants", "slot.uplink", "slot.drain", "slot.stats"]


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the process's place."""
    r = spans.Recorder()
    monkeypatch.setattr(spans, "RECORDER", r)
    return r


def children(records, index):
    return [s for s in records if s[4] == index]


def test_nesting_and_parents(rec):
    with spans.span("a") as a:
        with spans.span("b"):
            with spans.span("c"):
                pass
        with spans.span("d"):
            pass
    with spans.span("e"):
        pass
    got = rec.records()
    assert [(i, n, p) for i, n, _, _, p in got] == [
        (0, "a", None), (1, "b", 0), (2, "c", 1), (3, "d", 0), (4, "e", None)]
    for i, _, s, e, p in got:
        assert s <= e
        if p is not None:
            assert got[p][2] <= s and e <= got[p][3]
    assert a.seconds == (got[0][3] - got[0][2]) / 1e9
    assert rec.open == [] and rec.evicted == 0


def test_an_exception_closes_its_spans(rec):
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError("boom")
    assert [s[1] for s in rec.records()] == ["outer", "inner"]
    assert rec.open == []


def test_capacity_and_evicted(monkeypatch):
    r = spans.Recorder(capacity=4)
    monkeypatch.setattr(spans, "RECORDER", r)
    with spans.span("top"):
        for k in range(5):
            with spans.span(f"s{k}"):
                pass
    assert r.started == 6 and r.evicted == 2
    got = r.records()
    assert [(i, n, p) for i, n, _, _, p in got] == [
        (2, "s1", 0), (3, "s2", 0), (4, "s3", 0), (5, "s4", 0)]
    # an open span is in the buffer but not among the closed records
    with spans.span("open"):
        assert len(r.buf) == 4 and [s[1] for s in r.records()] == [
            "s2", "s3", "s4"]


def test_slot_spans_only_under_the_profiler(rec):
    with rec.slot_tier():
        assert spans.slot("slot") is spans.NOOP
        with spans.slot("slot"), spans.span("call"):
            pass
    assert [s[1] for s in rec.records()] == ["call"]
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.slot("outside"):          # no tier open: no span
            pass
        with rec.slot_tier():
            with spans.slot("slot"):
                with spans.slot("ring.insert"):
                    pass
        assert not rec.slots
    assert [(s[1], s[4]) for s in rec.records()] == [
        ("call", None), ("slot", None), ("ring.insert", 1)]


def test_the_clock_is_the_profilers(rec):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("ones"):
            torch.ones(1000)
    (_, _, a, b, _), = rec.records()
    ones = [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::ones"]
    assert len(ones) == 1
    s, e = ones[0]
    assert a <= s <= e <= b, (a, s, e, b)


def tiny_sweep(slots=24):
    """A sweep at the size of the benchmark's CPU tests: 16 hosts in 2
    racks, 2 runs of 60 W3 messages, chunks of 8 slots."""
    cfg = SimConfig(n_hosts=16, protocol="homa", max_slots=slots,
                    ring_cap=64, device="cpu",
                    fabric=FabricConfig(racks=2, up_cap=32))
    spec = SweepSpec(seeds=(3, 4), workload="W3", load=0.8, n_messages=60,
                     shared_alloc=True, chunk_slots=slots // 3,
                     streaming=True)
    return cfg, spec


def test_a_profiled_sweep_leaves_its_tree(rec):
    cfg, spec = tiny_sweep()
    with profile(activities=[ProfilerActivity.CPU]):
        run_sweep(cfg, spec)
    got = rec.records()
    calls = [s for s in got if s[1] == "sweep.call"]
    assert len(calls) == 1 and calls[0][4] is None and rec.evicted == 0
    kids = children(got, calls[0][0])
    assert [s[1] for s in kids] == SWEEP_CALL
    for a, b in zip(kids, kids[1:]):
        assert a[3] <= b[2]
    slots = [s for s in got if s[1] == "slot"]
    assert len(slots) == cfg.max_slots
    steps = [s[0] for s in kids if s[1] == "sweep.step"]
    assert {s[4] for s in slots} == set(steps)
    for s in slots:
        stages = children(got, s[0])
        # the route puts same-rack chunks into the downlink rings and the
        # rest into the uplink rings; the uplink drain puts the uplinks'
        # winners into the downlink rings
        assert [c[1] for c in stages] == [
            "slot.grants", "ring.insert", "ring.insert", "slot.uplink",
            "slot.drain", "slot.stats"]
        uplink = stages[3]
        assert [c[1] for c in children(got, uplink[0])] == ["ring.insert"]
    assert {s[1] for s in got} == {"sweep.call", *SWEEP_CALL, "slot",
                                   *SLOT_STAGES, "ring.insert"}


def test_an_unprofiled_sweep_keeps_call_spans_only(rec):
    cfg, spec = tiny_sweep(slots=9)
    run_sweep(cfg, spec)
    got = rec.records()
    assert [s[1] for s in got if s[4] is None] == ["sweep.call"]
    assert not any(s[1].startswith(("slot", "ring")) for s in got)
    assert len(got) == 1 + len(SWEEP_CALL)
