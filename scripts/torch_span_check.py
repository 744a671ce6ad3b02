#!/usr/bin/env python3
"""Check, on one CUDA card, how the benchmark's span-based readers
(``portbench/stages.py``) charge a traced stretch's device operations to
the port's spans, and what the slot spans cost.

    python3 scripts/torch_span_check.py --workload <cell> --seed <n>
        [--slot-spans on|off] [--out chiprun_out/span_check.json]

Runs the cell's traced run (``portbench/run.py --trace 1``'s path) once
and keeps its profiler window. Prints, as one JSON line (also written to
``--out``): the result's metrics; the window's runtime calls by name;
the device operations the end-aligned matching pairs with a launch, and
how many of those pairs the profiler's own correlation ids confirm; the
device us a slot charged to each span name, their sum beside
``device_us_per_slot``; the ``slot`` spans' host us a slot and the
runtime calls' us a slot inside them, by name; the spans that the
``srpt_topk`` and ``priority_arbiter`` kernels are charged to; the
stretch's wall time a slot; each span's six costliest operations
(device us a slot); each span's kernel records a slot, in all and by
operation; the fault layer's plans in the window (``faults.plan``: how
many, their host ms and the device ms of what they launched); and the
host cost of one span, timed on a recorder of its own.
``--slot-spans off`` records no slot spans in the window (the slot
tier stays closed), for the stretch's wall time without them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def correlated(prof) -> dict:
    """Device start ns -> the start ns of the runtime call that launched
    it, by the profiler's correlation ids."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    calls, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append((e.start_ns(), e.correlation_id()))
        else:
            calls.setdefault(e.correlation_id(), e.start_ns())
    return {s: calls.get(c) for s, c in ops}


def short(name: str) -> str:
    """A device operation's name without PyTorch's namespaces, cut to
    100 characters."""
    for part in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(part, "")
    return name[:100]


def span_cost_ns(n: int = 100_000) -> float:
    """Host ns to enter and leave one span, on a recorder of its own."""
    from repro_torch.core import spans
    r = spans.Recorder()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with spans.Span(r, "x"):
            pass
    return (time.perf_counter_ns() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slot-spans", choices=("on", "off"), default="on")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    from portbench import harness, profiling, stages
    from repro_torch.core import spans
    plan = harness.plan(harness.load_benchmark(), args.workload)
    harness.require_cards(plan.cell["chips"])

    kept = {}
    window, records = profiling.window, profiling.records

    def keep(fn):
        r, wall, prof = window(fn)
        kept["prof"] = prof
        return r, wall, prof

    def keep_records(prof):
        kept["rec"] = records(prof)
        return kept["rec"]

    profiling.window, profiling.records = keep, keep_records
    if args.slot_spans == "off":
        @contextlib.contextmanager
        def closed(self):
            yield
        spans.Recorder.slot_tier = closed
    result = plan.runner.run(plan, seed=args.seed, seconds=0.0, trace=True,
                             device="cuda", t_start=t_start)
    rec, prof = kept["rec"], kept["prof"]

    pairs = stages.match(rec)
    truth = correlated(prof)
    matched = [(d, c) for d, c in pairs if c is not None]
    confirmed = sum(truth.get(d[2]) == c[1] for d, c in matched)
    calls: dict = {}
    for name, _, _ in rec["host"]:
        calls[name] = calls.get(name, 0) + 1
    out = {"cell": args.workload, "seed": args.seed,
           "slot_spans": args.slot_spans, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "runtime_calls": dict(sorted(calls.items(),
                                        key=lambda kv: -kv[1])),
           "device_records": len(pairs), "matched": len(matched),
           "matched_share": len(matched) / len(pairs),
           "confirmed_by_correlation_id": confirmed,
           "wall_ms_per_slot": rec["wall_s"] * 1e3 / rec["slots"],
           "span_cost_ns": span_cost_ns()}
    spans_ = stages.stretch(rec)
    if spans_ is not None:
        tot = stages.charged(rec) or {}
        us = {str(k): v / 1e3 / rec["slots"] for k, v in tot.items()}
        out["charged_us_per_slot"] = dict(sorted(us.items(),
                                                 key=lambda kv: -kv[1]))
        out["charged_sum_us_per_slot"] = sum(us.values())
        owner, by_span, counts = {}, {}, {}
        hit = sorted(((c[1], d) for d, c in matched), key=lambda x: x[0])
        for (_, d), s in zip(hit, stages.innermost(spans_,
                                                   [t for t, _ in hit])):
            name = str(None if s is None else s[1])
            ops = by_span.setdefault(name, {})
            op = short(d[0])
            ops[op] = ops.get(op, 0) + d[3] - d[2]
            if d[1] == "kernel":
                n = counts.setdefault(name, {})
                n[op] = n.get(op, 0) + 1
            for k in ("srpt_topk", "priority_arbiter", "fused_slot"):
                if k in d[0]:
                    owner.setdefault(k, {})
                    owner[k][name] = owner[k].get(name, 0) + 1
        out["kernels_charged_to"] = owner
        # kernel records a slot by span, and by operation within each span
        out["kernel_records_per_slot"] = {
            name: sum(n.values()) / rec["slots"]
            for name, n in counts.items()}
        out["kernel_ops_per_slot"] = {
            name: {k: v / rec["slots"] for k, v in sorted(n.items())}
            for name, n in counts.items()}
        out["top_ops_us_per_slot"] = {
            name: [[k, v / 1e3 / rec["slots"]] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:6]]
            for name, ops in by_span.items()}
        out["stretch_spans"] = len(spans_)
        slots = [(s[2], s[3]) for s in spans_ if s[1] == "slot"]
        out["slot_span_us_per_slot"] = sum(b - a for a, b in slots) \
            / 1e3 / rec["slots"]
        out["runtime_us_per_slot_in_slots"] = {
            name: stages.overlap_ns(slots, [(a, b) for n, a, b in rec["host"]
                                            if n == name]) / 1e3
            / rec["slots"] for name in calls}
    # the fault layer's plans (``faults.plan``, call spans): each
    # ``run_slots`` call of the window builds its block's plan before its
    # first slot, so their operations charge to no slot span
    lo, hi = rec["span"]
    plans = [s for s in stages.program_spans() or []
             if s[1] == "faults.plan" and s[3] > lo and s[2] < hi]
    out["faults_plan"] = {
        "spans": len(plans),
        "host_ms": sum(s[3] - s[2] for s in plans) / 1e6,
        "device_ms": sum(d[3] - d[2] for d, c in matched
                         if any(s[2] <= c[1] <= s[3] for s in plans)) / 1e6}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
