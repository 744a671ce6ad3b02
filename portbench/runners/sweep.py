"""The runner of the sweep cells: one traffic mix's grid of runs, stepped
by the port's ``repro_torch.core.run_sweep`` in a closed loop of whole
calls.

Each call does what a user's call does over the grid's B runs: resolve,
prepare, step every slot as one batch, fold the streaming histogram and
return one ``SweepStats`` a run to the host. Every call of a run steps
the same grid, drawn from ``--seed``.

Set-up (``setup_s``): process start to the first timed call — imports,
CUDA's start, the grid's tables, loading the arbitration kernels (built
by nvcc on a checkout's first run only) and one warm-up call of
``WARMUP_SLOTS`` slots at the grid's batch and shapes, which launches
every kernel a slot launches.

``--trace 0`` measures the end-to-end metrics: ``sweep_rate``, B x slots
over every call of the window over its wall time, and ``peak_mem_gb``,
the card's allocation peak over the window. ``--trace 1`` makes one call
in which the slots ``[trace_from_slot, + trace_slots)`` of the mix run
in a profiler window of device activity only (:mod:`portbench.
profiling`) and hands its records to the per-layer metrics' readers. A window whose arbitration records fall short of the kernels'
launch counters lost records; the next stretch of slots is taken
instead, ``TRIES`` at most.

``correct``: after the window, the plain reference steps a sample of the
grid's runs drawn from the seed (``check_runs_per_load`` of each load)
from the same tables, and every integer output of those runs, in every
call of the window, is compared with it exactly.
"""
from __future__ import annotations

import dataclasses
import inspect
import subprocess
import sys
import time

import numpy as np

from portbench import profiling

# configuration keys that describe the deployment; every other key is a
# field of the port's SimConfig
META = ("name", "deployment", "source", "runner", "reference", "reduced",
        "assumed")
WARMUP_SLOTS = 8
TRIES = 3


def say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def program(config: dict, tables: list[dict], mix: dict, device: str):
    """The port's ``SimConfig`` and ``SweepSpec`` for the grid."""
    from repro_torch import core
    kw = {k: v for k, v in config.items() if k not in META}
    fab = kw.pop("fabric", None)
    cfg = core.SimConfig(**kw, device=device,
                         fabric=None if fab is None
                         else core.FabricConfig(**fab))
    spec = core.SweepSpec(
        tables=tuple(core.MessageTable(
            t["src"], t["dst"], t["size"], t["arrival_slot"],
            t["workload"], t["load"], t["slot_bytes"]) for t in tables),
        shared_alloc=mix["shared_alloc"], chunk_slots=mix["chunk_slots"],
        streaming=core.StreamSpec(**mix["streaming"]))
    return cfg, spec


def check_runs(mix: dict, seed: int) -> list[int]:
    """The runs the reference checks: ``check_runs_per_load`` seed
    indices of each load, drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    per = mix["seeds_per_load"]
    return sorted(i * per + int(j) for i in range(len(mix["loads"]))
                  for j in rng.choice(per, mix["check_runs_per_load"],
                                      replace=False))


def as_ints(s, config: dict, reference) -> dict:
    """A ``SweepStats``'s fields as the integers they were made from."""
    H, ms, sb = config["n_hosts"], config["max_slots"], config["slot_bytes"]
    hm = H * ms
    out = {"hist": np.asarray(s.hist).ravel(), "n_complete": s.n_complete,
           "n_messages": s.n_messages,
           "busy": round(s.busy_frac * hm), "wasted": round(s.wasted_frac
                                                          * hm),
           "uplink_busy": round(s.uplink_busy_frac * hm),
           "q_sum": round(s.q_mean_bytes / sb * hm),
           "q_max": round(s.q_max_bytes / sb),
           "prio_drained": np.asarray(s.prio_drained_bytes) // sb,
           "lost": s.lost_chunks, "n_unsched": s.alloc.n_unsched,
           "cutoffs": np.asarray(s.alloc.cutoffs, np.int64)}
    if config.get("fabric") is not None:
        out["u_busy"] = round(s.tor_up_busy_frac
                              * reference.n_uplinks(config) * ms)
    return out


def mismatches(got: dict, want: dict) -> int:
    """Integers of ``want`` that ``got`` does not equal (every one of a
    field that is missing or of another shape)."""
    n = 0
    for k in want.keys() | got.keys():
        a, b = np.asarray(got.get(k)), np.asarray(want.get(k))
        if k not in got or k not in want or a.shape != b.shape:
            n += max(a.size, b.size, 1)
        else:
            n += int((a != b).sum())
    return n


def judge(calls: list, want: dict, config: dict, reference, B: int):
    """(integers wrong over every call's checked runs, runs wrong)."""
    bad = runs_bad = 0
    for res in calls:
        for i, row in want.items():
            if len(res) != B:
                m = max(mismatches({}, row), 1)
            else:
                m = mismatches(as_ints(res[i], config, reference), row)
            bad += m
            runs_bad += m > 0
    return bad, runs_bad


class Stretch:
    """Stands in for ``repro_torch.core.sim.run_slots``: the call whose
    slots hold ``start`` runs ``[start, start + n)`` in a profiler window
    and the rest of its slots as usual; every other call passes
    through."""

    def __init__(self, run_slots, start: int, n: int, counters):
        self.orig, self.sig = run_slots, inspect.signature(run_slots)
        self.start, self.n, self.counters = start, n, counters
        self.rec = None

    def __call__(self, *args, **kw):
        a = self.sig.bind(*args, **kw).arguments
        lo, hi = a["start"], a["stop"]
        if self.rec is not None or not lo <= self.start < hi:
            return self.orig(*args, **kw)
        del a["start"], a["stop"]

        # the state passes through ``box`` so that no frame here holds a
        # state the program has moved past (no more than the untraced
        # loop holds)
        box = [a.pop("st")]

        def go(t0, t1):
            return self.orig(**a, st=box.pop(), start=t0, stop=t1)
        t = lo
        if self.start > lo:
            box.append(go(lo, self.start))
            t = self.start
        for attempt in range(TRIES):
            if t + self.n > hi:
                break
            before = self.counters()
            st, wall, prof = profiling.window(
                lambda t0=t: go(t0, t0 + self.n))
            box.append(st)
            del st
            rec = profiling.records(prof)
            launched = sum(v - before[k] for k, v in self.counters().items())
            seen = sum(1 for name, kind, _, _ in rec["device"]
                       if kind == "kernel"
                       and any(k in name for k in before))
            rec.update(slots=self.n, wall_s=wall, first_slot=t,
                       arbitration_launches=launched,
                       arbitration_records=seen)
            self.rec, t = rec, t + self.n
            say(f"trace stretch {attempt + 1}: slots {t - self.n}..{t - 1},"
                f" {wall:.3f} s wall, {len(rec['device'])} device records,"
                f" markers {rec['markers']}/{profiling.MARKERS}, "
                f"arbitration records {seen} of {launched} launches")
            if seen == launched:
                break
            say("the profiler lost arbitration records; taking the next "
                "stretch")
        return go(t, hi) if t < hi else box.pop()


def card_lines() -> dict:
    """The card's name, power limit and software, on an earlier line."""
    import torch
    kind = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        limit = f"nvidia-smi failed: {e}"
    say(f"card: {kind}; {torch.cuda.device_count()} visible; power limit: "
        f"{limit}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"platform": "gpu", "kind": kind, "count": 1}


def run(plan, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    marks = [("start to the runner", time.perf_counter())]
    import torch
    from repro_torch.core import run_sweep, sim
    from repro_torch.kernels.arbiter.kernel import launch_counts
    marks.append(("program import", time.perf_counter()))

    config, mix, ref = plan.config, plan.traffic, plan.reference
    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    torch.zeros(1, device=device)
    marks.append(("device start", time.perf_counter()))
    tables = plan.generator.tables(mix, config, seed)
    marks.append(("tables", time.perf_counter()))
    B, M = len(tables), len(tables[0]["size"])
    if any(len(t["size"]) != M for t in tables) or not mix["shared_alloc"]:
        raise ValueError("the sweep runner steps one batch: every table of "
                         "the mix has one length and shares one allocation")
    cfg, spec = program(config, tables, mix, device)
    say(f"cell {plan.cell['name']}: {config['protocol']} on backend "
        f"{cfg.backend!r}, B = {B} runs x {config['max_slots']} slots, "
        f"{M} messages a run, {config['n_hosts']} hosts")
    run_sweep(dataclasses.replace(cfg, max_slots=WARMUP_SLOTS), spec)
    sync()
    marks.append(("warm-up call", time.perf_counter()))
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    say("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip([("", t_start)] + marks, marks)))
    if trace:
        stretch = Stretch(sim.run_slots, mix["trace_from_slot"],
                          mix["trace_slots"], launch_counts)
        sim.run_slots = stretch
        try:
            calls = [run_sweep(cfg, spec)]
        finally:
            sim.run_slots = stretch.orig
        rec = stretch.rec
        if rec is None:
            raise RuntimeError("the traced call never reached slot "
                               f"{mix['trace_from_slot']}")
    else:
        calls = []
        while True:
            calls.append(run_sweep(cfg, spec))
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
    sync()
    dev = card_lines() if on_card else {"platform": "cpu", "kind": "cpu",
                                        "count": 1}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say(f"window: {len(calls)} call(s) in {time.perf_counter() - t0:.3f} s;"
        f" set-up {setup_s:.3f} s; memory peak {peak} bytes (set-up "
        f"{peak_setup})")
    dev["memory_peak_bytes"] = max(peak, peak_setup)

    # the reference, once the window has closed and the peak is read
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    check = check_runs(mix, seed)
    rows = ref.run(config, tables, mix["streaming"], mix["chunk_slots"],
                   mix["shared_alloc"], check, device)
    want = {i: {**row, "n_messages": len(tables[i]["size"])}
            for i, row in zip(check, rows)}
    bad, runs_bad = judge(calls, want, config, ref, B)
    say(f"reference: {len(check)} runs in {time.perf_counter() - t_ref:.1f}"
        f" s; checked in {len(calls)} call(s): {runs_bad} wrong")

    out = {"correct": bad == 0, "attempted": B * len(calls),
           "failed": runs_bad}
    if trace:
        rec["cell"] = dict(
            B=B, H=config["n_hosts"], cap=config["ring_cap"],
            U=0 if config.get("fabric") is None
            else config["fabric"]["racks"] * ref.n_uplinks(config),
            ucap=0 if config.get("fabric") is None
            else config["fabric"]["up_cap"],
            M=M, K=ref.grant_k(config, ref.allocate(
                np.concatenate([t["size"] for t in tables]),
                config["rtt_slots"] * config["slot_bytes"],
                config["n_prios"])))
        metrics = {}
        for m, reader in plan.per_layer:
            v = reader.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        lo, hi = rec["span"]
        dev.update(busy_s=profiling.busy_ns(rec) / 1e9,
                   window_s=(hi - lo) / 1e9)
        out.update(metrics=metrics, device=dev, breakdown={
            "device_ops": profiling.top_device_ops(rec),
            "idle_gaps": profiling.idle_gaps(rec)})
    else:
        e2e = {"sweep_rate": B * config["max_slots"] * len(calls) / wall,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        out.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                        "unit": m["unit"]}
                            for m in plan.end_to_end}, device=dev)
    out["checks"] = {"mismatched_ints": {"value": bad, "limit": 0}}
    return out
