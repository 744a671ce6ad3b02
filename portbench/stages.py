"""The program's own spans beside a traced stretch's records: the part the
readers of the span-based per-layer metrics share.

A traced run's window (:mod:`portbench.profiling`) records device
activity only: the card's operations and the CUDA runtime's calls on
the host, in ns of the profiler's clock. The port keeps its own spans
in memory on the same clock (``repro_torch.core.spans``): call spans
(``sweep.*``) always, slot spans (``slot``, ``slot.*``, ``ring.insert``)
while the profiler records. Spans are host-clock readings taken in the
traced run. Here:

* :func:`program_spans` reads the port's span buffer, ``None`` where the
  port has none;
* :func:`stretch` picks the spans of the traced stretch: its ``slot``
  spans and every span inside them; :func:`traced_call` the
  ``sweep.call`` span that holds it;
* :func:`charged` matches the device operations with the runtime calls
  that launched them and charges each to the innermost span that holds
  its call.

Matching: ``rec["device"]`` carries no correlation id, but on one stream
the card runs operations in launch order. So the launch-type runtime
calls (kernel launches, async copies and fills) in start order are
paired one to one with the device operations in start order, aligned
from the end: the window clips a launch whose call ended before the
first device operation began. Operations and calls left over on either
side are unmatched. Every reader returns ``None`` when no span of the
stretch is in the buffer, when the stretch's ``slot`` spans do not
number ``rec["slots"]``, or when the unmatched number more than
:data:`UNMATCHED_MAX` of the device operations.
"""
from __future__ import annotations

import bisect

# the runtime calls that put one operation on the stream
LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
UNMATCHED_MAX = 0.01


def program_spans() -> list[tuple] | None:
    """The port's closed spans, ``(index, name, start_ns, end_ns,
    parent)`` oldest first; ``None`` where the port records none."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return spans.RECORDER.records()


def stretch(rec: dict) -> list[tuple] | None:
    """The ``slot`` spans that overlap the stretch's window and every
    span inside them, in start order; ``None`` where they are missing
    or do not number ``rec["slots"]``."""
    got = program_spans() if rec["device"] else None
    if not got:
        return None
    lo, hi = rec["span"]
    slots = [s for s in got if s[1] == "slot" and s[3] > lo and s[2] < hi]
    if not slots or len(slots) != rec["slots"]:
        return None
    a, b = slots[0][2], slots[-1][3]
    return [s for s in got if s[2] >= a and s[3] <= b]


def traced_call(rec: dict) -> tuple[tuple, list[tuple]] | None:
    """The ``sweep.call`` span whose ``sweep.step`` holds the stretch's
    window, and the spans directly inside it; ``None`` where the stretch
    or that call is missing."""
    if stretch(rec) is None:
        return None
    spans = program_spans()
    lo, hi = rec["span"]
    steps = [s for s in spans
             if s[1] == "sweep.step" and s[2] <= lo and s[3] >= hi]
    call = [s for s in spans if steps and s[0] == steps[0][4]]
    if len(steps) != 1 or not call or call[0][1] != "sweep.call":
        return None
    return call[0], [s for s in spans if s[4] == call[0][0]]


def launch_calls(rec: dict) -> list[tuple]:
    """The window's launch-type runtime calls, in start order."""
    return sorted((h for h in rec["host"] if h[0].startswith(LAUNCHES)),
                  key=lambda h: h[1])


def match(rec: dict) -> list[tuple]:
    """``(device operation, its launch call or None)`` for every device
    operation of the window, in start order."""
    dev = sorted(rec["device"], key=lambda d: d[2])
    calls = launch_calls(rec)
    n = min(len(dev), len(calls))
    return [(d, None) for d in dev[:len(dev) - n]] + list(
        zip(dev[len(dev) - n:], calls[len(calls) - n:]))


def innermost(spans: list[tuple], times: list[int]) -> list:
    """The innermost of the nested ``spans`` (start order) that holds
    each of the sorted ``times``, or ``None``."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][2] <= t:
            while stack and stack[-1][3] < spans[i][2]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][3] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def charged(rec: dict) -> dict | None:
    """Device ns of the window by the name of the innermost span that
    launched each operation (``None``: no span of the stretch, or
    unmatched); ``None`` where a reader has nothing to read."""
    spans = stretch(rec)
    if spans is None:
        return None
    pairs = match(rec)
    if abs(len(pairs) - len(launch_calls(rec))) \
            > UNMATCHED_MAX * len(pairs):
        return None
    tot: dict = {}
    for d, c in pairs:
        if c is None:
            tot[None] = tot.get(None, 0) + d[3] - d[2]
    hit = sorted(((c[1], d) for d, c in pairs if c is not None),
                 key=lambda x: x[0])
    for (_, d), s in zip(hit, innermost(spans, [t for t, _ in hit])):
        name = None if s is None else s[1]
        tot[name] = tot.get(name, 0) + d[3] - d[2]
    return tot


def stage_us_per_slot(rec: dict, names: tuple) -> float | None:
    """Device us a slot of the operations charged to ``names``; 0.0 for
    a stage that launched nothing."""
    tot = charged(rec)
    if tot is None:
        return None
    return sum(tot.get(n, 0) for n in names) / 1e3 / rec["slots"]


def overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """The length of the intersection of two unions of intervals."""
    def union(iv):
        out: list[list[int]] = []
        for s, e in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out
    ua, ub = union(a), union(b)
    starts = [s for s, _ in ub]
    n = 0
    for s, e in ua:
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(ub) and ub[j][0] < e:
            n += max(0, min(e, ub[j][1]) - max(s, ub[j][0]))
            j += 1
    return n
