"""Profiler windows on the card and the records a traced run hands to
the metric readers.

``window`` is ``chip_smoke.py``'s ``_window``, with its repair of lost
records: in some processes the profiler drops the first kernel records
of every session after the first, so every window opens with
``MARKERS`` launches of a spin kernel, synchronized before the window's
idle trace and left out of every count. It records device activity only:
recording the host's operations too slowed a traced slot from ≈ 7.2 to
10.2 ms on an H100's host, and the host sets much of the pace.

:func:`records` turns one window into plain data: every device
operation (kernels, copies, fills) and every host operation the
profiler recorded (the CUDA runtime's calls), in nanoseconds of the
profiler's clock, within the window's span: from the start of its first
device operation to the end of its last, the markers left out.
"""
from __future__ import annotations

import time

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARKERS = 256                   # a window's first launches (~1 ms)
IDLE_S = 0.05                   # idle trace either side of the work


def window(fn):
    """Run ``fn`` under the profiler; returns (its result, wall seconds,
    the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(IDLE_S)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(IDLE_S)
    return r, wall, prof


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def busy_intervals(rec: dict) -> list[tuple[int, int]]:
    """The union of the device operations' intervals, clipped to the
    span, as sorted disjoint ``(start, end)`` pairs in ns."""
    lo, hi = rec["span"]
    out: list[list[int]] = []
    for a, b in sorted((max(a, lo), min(b, hi))
                       for _, _, a, b in rec["device"]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(rec: dict) -> int:
    return sum(b - a for a, b in busy_intervals(rec))


def idle_gaps(rec: dict, n: int = 10) -> list[list]:
    """The ``n`` longest stretches of the span in which the card ran
    nothing, each named by the host operation that overlaps it most
    (the shortest such on a tie): ``[[name, seconds]]``."""
    lo, hi = rec["span"]
    edges = [lo] + [t for iv in busy_intervals(rec) for t in iv] + [hi]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:n]
    out = []
    for length, a, b in gaps:
        best = max(((min(b, e) - max(a, s), -(e - s), name)
                    for name, s, e in rec["host"] if e > a and s < b),
                   default=(0, 0, "no host operation"))
        out.append([best[2], length / 1e9])
    return out


def top_device_ops(rec: dict, n: int = 10) -> list[list]:
    """The ``n`` device operations that took the most time, summed by
    name: ``[[name, seconds]]``."""
    tot: dict[str, int] = {}
    for name, _, a, b in rec["device"]:
        tot[name] = tot.get(name, 0) + b - a
    return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                            key=lambda kv: -kv[1])[:n]]


def records(prof) -> dict:
    """The window's span ``(start, end)`` in ns, its device operations
    ``[(name, kind, start, end)]``, the host operations ``[(name, start,
    end)]`` that overlap the span, and the marker records seen."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, markers = [], [], 0
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() != cuda:
            host.append((name, a, b))
        elif MARKER in name:
            markers += 1
        elif not e.is_user_annotation():
            device.append((name, _kind(name), a, b))
    if not device:
        raise RuntimeError("the profiler window holds no device operation")
    lo, hi = min(d[2] for d in device), max(d[3] for d in device)
    return {"span": (lo, hi), "device": device,
            "host": [h for h in host if h[2] > lo and h[1] < hi],
            "markers": markers}
