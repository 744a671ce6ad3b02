"""The readers of the port's spans (``portbench/stages.py`` and the seven
span-based metrics) on a canned window and canned spans: the matching
of device operations with their launches, the charging to the innermost
span, and the cases with nothing to read."""
import sys

import pytest

import portbench_tiny  # noqa: F401
from portbench import stages
from portbench.harness import load_module
from repro_torch import core
from repro_torch.core import spans

US = 1000                                   # ns
SPAN_METRICS = ("host_only_ms_per_run", "host_us_per_slot",
                "grants_us_per_slot", "insert_us_per_slot",
                "drain_us_per_slot", "stats_us_per_slot",
                "prepare_ms_per_run")
read = {n: load_module("metrics", n).read for n in SPAN_METRICS}
SLOTS, T0, PITCH = 40, 1000, 100            # slot k spans T0 + k PITCH us
# a slot's spans (offsets in us) and the launches made in each outside
# its inner spans; every launch call takes 0.5 us and its operation runs
# 1 us from 1 us later
SLOT = ("slot", 0, 95, [
    ("slot.grants", 2, 20, [], [3, 6]),
    ("ring.insert", 35, 40, [], [36, 38]),
    ("slot.uplink", 50, 60, [("ring.insert", 55, 58, [], [56])], [51]),
    ("slot.drain", 70, 80, [], [71, 73]),
    ("slot.stats", 81, 85, [], [])], [22, 31, 91])
PER_SLOT = {"grants": 2, "insert": 3, "drain": 3, "stats": 0, "rest": 3}


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder on a clock the test sets."""
    r = spans.Recorder()
    clock = [0]
    monkeypatch.setattr(spans, "RECORDER", r)
    monkeypatch.setattr(spans, "now", lambda: clock[0])
    r.clock = clock
    return r


def record(r, name, a, b, inner=(), own=(), base=0):
    """Span ``name`` over ``[base + a, base + b]`` us with ``inner``
    spans, on the recorder's clock; returns the times in us of its
    launches, ``own`` and its inner spans'."""
    r.clock[0] = (base + a) * US
    times = [base + t for t in own]
    with spans.span(name):
        for child in inner:
            times += record(r, *child, base=base)
        r.clock[0] = (base + b) * US
    return times


def canned(r, B=2):
    """A call of ``SLOTS`` traced slots, and the window's records: each
    launch a ``cudaLaunchKernel`` call; in each slot a
    ``cudaStreamIsCapturing`` call of 1 us in ``slot.grants`` and a
    ``Command Buffer Full`` record of 2 us in ``slot.drain``, and one
    more of those between slots; the operations in launch order, the
    first one's launch clipped off by the window."""
    launches = []
    r.clock[0] = 0
    with spans.span("sweep.call"):
        record(r, "sweep.prepare", 10, 400)
        r.clock[0] = 990 * US
        with spans.span("sweep.step"):
            for k in range(SLOTS):
                launches += record(r, *SLOT, base=T0 + k * PITCH)
            r.clock[0] = 5100 * US
        record(r, "sweep.to_host", 5120, 5300)
        r.clock[0] = 6000 * US
    launches.sort()
    names = {3: "void srpt_topk_kernel<8>(...)",
             51: "void priority_arbiter_kernel<64, 2>(...)",
             71: "void priority_arbiter_kernel<64, 2>(...)",
             38: "Memcpy DtoD (Device -> Device)"}
    device = [(names.get((t - T0) % PITCH, "elementwise_kernel"),
               "copy" if (t - T0) % PITCH == 38 else "kernel",
               (t + 1) * US, (t + 2) * US) for t in launches]
    host = [("cudaLaunchKernel", t * US, t * US + US // 2) for t in launches]
    for k in range(SLOTS):
        at = T0 + k * PITCH
        host += [("cudaStreamIsCapturing", (at + 10) * US, (at + 11) * US),
                 ("Command Buffer Full", (at + 74) * US, (at + 76) * US),
                 ("Command Buffer Full", (at + 96) * US, (at + 98) * US)]
    lo, hi = device[0][2], device[-1][3]
    return {"slots": SLOTS, "span": (lo, hi), "device": device,
            "host": [h for h in host if h[2] > lo and h[1] < hi],
            "markers": 256, "cell": dict(B=B, H=4, cap=16, U=2, ucap=8,
                                         M=10, K=3)}


def test_matching_from_the_end_with_a_clipped_first_launch(rec):
    w = canned(rec)
    # every launch call but the clipped one
    assert len(stages.launch_calls(w)) == len(w["device"]) - 1
    pairs = stages.match(w)
    assert len(pairs) == len(w["device"])
    assert pairs[0][1] is None                  # its launch call is gone
    for d, c in pairs[1:]:
        assert c[0] == "cudaLaunchKernel" and d[2] == c[1] + US
    got = stages.charged(w)
    assert got[None] == 1 * US                  # the one unmatched
    assert sum(got.values()) == sum(b - a for _, _, a, b in w["device"])
    # the top-K of slot 0 lost its launch; the rest charge to grants
    topk = [s for d, c in pairs if "srpt_topk" in d[0] and c is not None
            for s in stages.innermost(stages.stretch(w), [c[1]])]
    assert len(topk) == SLOTS - 1 and {s[1] for s in topk} == {
        "slot.grants"}


def test_charging_to_the_innermost_span(rec):
    w = canned(rec)
    got = stages.charged(w)
    assert got["ring.insert"] == PER_SLOT["insert"] * SLOTS * US
    assert got["slot.uplink"] == SLOTS * US
    assert got["slot.drain"] == 2 * SLOTS * US
    assert got["slot"] == PER_SLOT["rest"] * SLOTS * US
    vals = {n: read[n](w) for n in SPAN_METRICS}
    assert vals["grants_us_per_slot"] == pytest.approx(
        (PER_SLOT["grants"] * SLOTS - 1) / SLOTS)
    assert vals["insert_us_per_slot"] == PER_SLOT["insert"]
    assert vals["drain_us_per_slot"] == PER_SLOT["drain"]
    assert vals["stats_us_per_slot"] == 0.0     # launched nothing
    # per slot: 95 us of slot spans, less the 2 us blocked on a full
    # queue inside them; the launch calls and the other runtime call stay
    assert vals["host_us_per_slot"] == 93
    # 6000 us of call, less 990 .. 5300 us from the first step to the
    # copy to the host, over B = 2 runs
    assert vals["host_only_ms_per_run"] == pytest.approx(1.69 / 2)
    # 390 us of prepare over B = 2 runs
    assert vals["prepare_ms_per_run"] == pytest.approx(0.39 / 2)


def test_a_slot_count_mismatch_reads_none(rec):
    w = dict(canned(rec), slots=SLOTS - 1)
    for n in SPAN_METRICS:
        assert read[n](w) is None, n


def test_evicted_spans_read_none(monkeypatch):
    r = spans.Recorder(capacity=200)
    clock = [0]
    monkeypatch.setattr(spans, "RECORDER", r)
    monkeypatch.setattr(spans, "now", lambda: clock[0])
    r.clock = clock
    w = canned(r)
    assert r.evicted > 0
    for n in SPAN_METRICS:
        assert read[n](w) is None, n


def test_unmatched_launches_read_none(rec):
    w = canned(rec)
    # eight launch calls lost in the middle: 9 of 440 operations have no
    # call left
    del w["host"][100:108]
    assert len(stages.launch_calls(w)) == len(w["device"]) - 9
    assert stages.charged(w) is None
    for n in ("grants_us_per_slot", "insert_us_per_slot",
              "drain_us_per_slot", "stats_us_per_slot"):
        assert read[n](w) is None, n


def test_no_device_records_and_no_spans_read_none(rec, monkeypatch):
    w = canned(rec)
    for n in SPAN_METRICS:
        assert read[n](dict(w, device=[])) is None, n
    # a program without the span recorder (an older checkout)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    monkeypatch.delattr(core, "spans")
    assert stages.program_spans() is None
    for n in SPAN_METRICS:
        assert read[n](w) is None, n


def test_a_window_outside_the_spans_reads_none(rec):
    w = canned(rec)
    shifted = dict(w, span=(10 ** 12, 10 ** 12 + 5))
    for n in SPAN_METRICS:
        assert read[n](shifted) is None, n


@pytest.mark.parametrize("a,b,n", [
    ([(0, 10)], [(5, 15)], 5),
    ([(0, 10), (20, 30)], [(5, 25)], 10),
    ([(0, 10)], [(2, 4), (3, 6), (8, 12)], 6),
    ([(0, 10)], [], 0),
])
def test_overlap_ns(a, b, n):
    assert stages.overlap_ns(a, b) == n
