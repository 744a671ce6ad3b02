#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero and prints no
result line:

1. card    the card's name and power limit (``nvidia-smi``), then the
           build of ``csrc/arbiter.cu`` for sm_90a and its time
2. kernels each hand-written kernel against its plain PyTorch version on
           the card — full-width shapes of the main path, ragged shapes,
           empty rows, ties, M < K — requiring exact equality; then each
           kernel's time beside the plain version's and the library
           call's (CUDA events, median of repeated batches)
3. goldens ``tests/golden/fabric_disabled.json`` and ``fabric_enabled.json``
           replayed for all six protocols on the kernel backend, bit-exact
4. full    the paper's 144-host, 9-rack full-bisection leaf-spine network,
           W3 at load 0.8 with 8000 messages, homa, 20000 slots, on the
           kernel backend (launches counted) and on the plain backend;
           the integer outputs must be identical
5. window  a steady window of that run: no host sync inside the slot
           loop, then a profiled stretch — device busy share, kernels
           per slot and each kernel's device time per launch

Then one JSON line with each kernel's numbers, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PROTOCOLS = ("homa", "basic", "phost", "pias", "pfabric", "ndp")
FULL = dict(workload="W3", load=0.8, n_messages=8000, seed=0, n_hosts=144,
            racks=9, oversub=1.0, ring_cap=1024, up_cap=512,
            max_slots=20000)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


def time_ms(fn, *, batch: int = 100, reps: int = 15) -> float:
    """Median over ``reps`` of the per-call time of ``batch`` back-to-back
    calls, between CUDA events on the current stream."""
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# ------------------------------------------------------------- phase 1 -----

def phase_card():
    import torch
    from repro_torch.kernels.arbiter import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    log = (build.library_path().parent / "build.log").read_text()
    say(f"[card] built {build.library_path()} in {dt:.2f} s")
    for line in log.splitlines():
        if "ptxas" in line and ("registers" in line or "Compiling" in line
                                or "spill" in line):
            say(f"[card]   {line.strip()}")
    return smi


# ------------------------------------------------------------- phase 2 -----

def _arb_inputs(rng, H, cap, *, n_prios=8, p_elig=0.5, seq_hi=20000):
    import numpy as np
    import torch
    prio = rng.integers(0, n_prios, (H, cap)).astype(np.int32)
    seq = rng.integers(0, seq_hi, (H, cap)).astype(np.int32)
    elig = rng.random((H, cap)) < p_elig
    dev = "cuda"
    return (torch.from_numpy(prio).to(dev), torch.from_numpy(seq).to(dev),
            torch.from_numpy(elig).to(dev))


def _topk_keys(rng, H, M, *, p_pos=0.05, hi=1 << 30):
    """Grant-matrix-like keys: mostly 0 (ineligible), some positive keys
    with duplicates."""
    import numpy as np
    import torch
    keys = np.where(rng.random((H, M)) < p_pos,
                    rng.integers(1, hi, (H, M)), 0).astype(np.int32)
    return torch.from_numpy(keys).to("cuda")


def _arb_cases(rng):
    import torch
    from repro_torch.kernels.arbiter.ref import BIG
    cases = {}
    for name, (H, cap) in {"down 144x1024": (144, 1024),
                           "up 144x512": (144, 512),
                           "ragged 13x1000": (13, 1000),
                           "ragged 5x33": (5, 33)}.items():
        cases[name] = _arb_inputs(rng, H, cap)
    # the ring state as the simulator holds it: empty slots carry BIG
    p, s, e = _arb_inputs(rng, 144, 1024, p_elig=0.02)
    cases["sparse with BIG slots"] = (torch.where(e, p, BIG),
                                      torch.where(e, s, BIG), e)
    p, s, e = _arb_inputs(rng, 144, 1024)
    e[::3] = False                                   # all-ineligible rows
    cases["empty rows"] = (p, s, e)
    p, s, e = _arb_inputs(rng, 144, 1024, n_prios=1, seq_hi=2)
    cases["duplicate (prio, seq) ties"] = (p, s, e)
    p = torch.zeros((16, 700), dtype=torch.int32, device="cuda")
    cases["all equal, all eligible"] = (p, p.clone(),
                                        torch.ones_like(p, dtype=torch.bool))
    return cases


def _topk_cases(rng):
    import torch
    from repro_torch.kernels.arbiter.ref import NEG
    cases = {}
    for K in (1, 7):
        cases[f"grant 144x8000 K={K}"] = (_topk_keys(rng, 144, 8000), K)
    cases["ties 144x8000 K=7"] = (_topk_keys(rng, 144, 8000, hi=3), 7)
    cases["dense 144x8000 K=7"] = (_topk_keys(rng, 144, 8000, p_pos=1.0), 7)
    cases["ragged 13x1000 K=7"] = (_topk_keys(rng, 13, 1000, p_pos=0.3), 7)
    cases["all zero 8x300 K=4"] = (
        torch.zeros((8, 300), dtype=torch.int32, device="cuda"), 4)
    small = torch.tensor([[5, 0, 5], [0, 0, 0], [NEG, 3, 0], [NEG, NEG, NEG],
                          [1, 2, 3]], dtype=torch.int32, device="cuda")
    cases["M<K zeros and NEG 5x3 K=7"] = (small, 7)
    cases["M<K 4x1 K=2"] = (_topk_keys(rng, 4, 1, p_pos=0.5), 2)
    return cases


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_kernels():
    import numpy as np
    import torch
    from repro_torch.kernels.arbiter import kernel
    from repro_torch.kernels.arbiter.ref import (priority_arbiter_ref,
                                                 srpt_topk_ref)
    rng = np.random.default_rng(0)
    err = {"priority_arbiter": 0, "srpt_topk": 0}
    for name, (p, s, e) in _arb_cases(rng).items():
        got = kernel.priority_arbiter(p, s, e)
        want = priority_arbiter_ref(p, s, e)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"priority_arbiter differs: {name}")
            err["priority_arbiter"] = max(err["priority_arbiter"],
                                          _max_err(g, w))
        say(f"[kernels] priority_arbiter == plain: {name}")
    for name, (keys, K) in _topk_cases(rng).items():
        got = kernel.srpt_topk(keys, K)
        want = srpt_topk_ref(keys, K)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"srpt_topk differs: {name}")
            err["srpt_topk"] = max(err["srpt_topk"], _max_err(g, w))
        say(f"[kernels] srpt_topk == plain: {name}")

    # times at the main path's shapes (inputs stay in L2, as in the loop,
    # where the preceding operations have just written them)
    perf = {}
    p, s, e = _arb_inputs(rng, 144, 1024)
    up = _arb_inputs(rng, 144, 512)
    H, cap = p.shape
    perf["priority_arbiter"] = dict(
        shape=f"({H}, {cap}) int32 x2 + bool",
        ms=time_ms(lambda: kernel.priority_arbiter(p, s, e)),
        plain_ms=time_ms(lambda: priority_arbiter_ref(p, s, e)),
        library_ms=None,
        bound_ms=(H * cap * 9 + 2 * H * 4) / HBM_BYTES_PER_S * 1e3,
        up_ms=time_ms(lambda: kernel.priority_arbiter(*up)),
        up_plain_ms=time_ms(lambda: priority_arbiter_ref(*up)),
        up_bound_ms=(144 * 512 * 9 + 2 * 144 * 4) / HBM_BYTES_PER_S * 1e3)
    keys = _topk_keys(rng, 144, 8000, p_pos=0.01)
    K = 7
    H, M = keys.shape
    perf["srpt_topk"] = dict(
        shape=f"({H}, {M}) int32, K={K}",
        ms=time_ms(lambda: kernel.srpt_topk(keys, K)),
        plain_ms=time_ms(lambda: srpt_topk_ref(keys, K)),
        library_ms=time_ms(lambda: torch.topk(keys, K, dim=1)),
        bound_ms=(H * M * 4 + 2 * H * K * 4) / HBM_BYTES_PER_S * 1e3)
    for name, d in perf.items():
        say(f"[kernels] {name} {d['shape']}: "
            + ", ".join(f"{k}={v!r}" for k, v in d.items() if k != "shape"))
    return err, perf


# ------------------------------------------------------------- phase 3 -----

def _golden_run(meta, proto, fabric, backend):
    from repro_torch.core import SimConfig, make_messages, simulate
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    cfg = SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=fabric, backend=backend, device="cuda")
    return simulate(cfg, tbl)


def phase_goldens():
    from repro_torch.core import FabricConfig
    for name in ("fabric_disabled", "fabric_enabled"):
        g = json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                       .read_text())
        meta = g["meta"]
        fab = (FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                            up_cap=meta["up_cap"])
               if name == "fabric_enabled" else None)
        for proto in PROTOCOLS:
            t0 = time.perf_counter()
            r = _golden_run(meta, proto, fab, "cuda")
            want = g["protocols"][proto]
            got = {"completion": [int(x) for x in r.completion],
                   "lost_chunks": int(r.lost_chunks),
                   "q_max_bytes": [int(x) for x in r.q_max_bytes],
                   "prio_drained_bytes": [int(x)
                                          for x in r.prio_drained_bytes],
                   "busy": [round(float(x), 8) for x in r.busy_frac]}
            if fab is not None:
                got["tor_up_q_max_bytes"] = [int(x)
                                             for x in r.tor_up_q_max_bytes]
                got["tor_up_lost_chunks"] = int(r.tor_up_lost_chunks)
            bad = [k for k in want if got[k] != want[k]]
            check(not bad, f"{name} {proto}: differs from the golden in "
                           f"{bad}")
            say(f"[goldens] {name} {proto}: bit-exact "
                f"({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------- phase 4 -----

def _full_config(backend):
    from repro_torch.core import (FabricConfig, SimConfig, make_messages)
    f = FULL
    tbl = make_messages(f["workload"], n_hosts=f["n_hosts"], load=f["load"],
                        n_messages=f["n_messages"], slot_bytes=256,
                        seed=f["seed"])
    cfg = SimConfig(protocol="homa", n_hosts=f["n_hosts"],
                    ring_cap=f["ring_cap"], max_slots=f["max_slots"],
                    fabric=FabricConfig(racks=f["racks"],
                                        oversub=f["oversub"],
                                        up_cap=f["up_cap"]),
                    backend=backend, device="cuda")
    return cfg, tbl


def _full_run(backend):
    import torch
    from repro_torch.core import simulate
    cfg, tbl = _full_config(backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = simulate(cfg, tbl)          # ends in host copies: synchronized
    wall = time.perf_counter() - t0
    return r, wall, int(tbl.arrival_slot.max())


def phase_full():
    import numpy as np
    from repro_torch.kernels.arbiter import kernel
    kernel.reset_launch_counts()
    r_k, wall_k, horizon = _full_run("cuda")
    launches = kernel.launch_counts()
    r_p, wall_p, _ = _full_run("reference")
    slots = FULL["max_slots"]
    check(launches == {"priority_arbiter": 2 * slots, "srpt_topk": slots},
          f"main path launches {launches}, expected 2 arbiter and 1 top-K "
          f"per slot over {slots} slots")
    for field in ("completion", "q_max_bytes", "prio_drained_bytes",
                  "tor_up_busy_frac", "tor_up_q_max_bytes", "busy_frac"):
        check(np.array_equal(getattr(r_k, field), getattr(r_p, field)),
              f"full run: kernel and plain backends differ in {field}")
    for field in ("lost_chunks", "tor_up_lost_chunks"):
        check(getattr(r_k, field) == getattr(r_p, field),
              f"full run: kernel and plain backends differ in {field}")
    check(np.array_equal(r_k.tor_up_q_mean_bytes, r_p.tor_up_q_mean_bytes),
          "full run: tor_up_q_mean_bytes differs")
    check(r_k.n_complete > 0 and np.isfinite(r_k.slowdown[r_k.done]).all()
          and (r_k.slowdown[r_k.done] > 0).all(),
          "full run: completions missing or slowdowns not positive")
    s = r_k.summary()
    say(f"[full] 144 hosts, 9 racks x 16 uplinks, W3 load 0.8, 8000 msgs "
        f"(arrival horizon {horizon} slots), {slots} slots")
    say(f"[full] cuda backend: {wall_k:.2f} s wall, "
        f"{slots / wall_k:.1f} slots/s; launches {launches}")
    say(f"[full] reference backend: {wall_p:.2f} s wall, "
        f"{slots / wall_p:.1f} slots/s")
    say(f"[full] identical integer outputs; completed "
        f"{r_k.n_complete}/{r_k.n_messages} "
        f"({r_k.completion_rate:.4f}); p99_small {s['p99_small']}; "
        f"p99_all {s['p99_all']}; lost {r_k.lost_chunks}")
    return launches


# ------------------------------------------------------------- phase 5 -----

WINDOW_START, WINDOW_SLOTS = 3000, 100


def phase_window():
    """A steady window of the full run on the kernel backend: 20 slots in
    which any host sync raises, then ``WINDOW_SLOTS`` slots under the
    profiler — wall time per slot, device busy share, kernels per slot,
    and the two kernels' device time per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import _init_state, prepare, run_slots
    cfg, tbl = _full_config("cuda")
    proto = get_protocol(cfg.protocol)
    S, alloc = prepare(cfg, tbl)
    n_sched = proto.n_sched(cfg, alloc)
    t = WINDOW_START
    st = run_slots(cfg, proto, S, _init_state(cfg, proto, len(tbl.size)),
                   n_sched, 0, t)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host sync now raises
    try:
        st = run_slots(cfg, proto, S, st, n_sched, t, t + 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t += 20
    torch.cuda.synchronize()
    say(f"[window] slots {t - 20}..{t - 1}: no host sync in the loop")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slots(cfg, proto, S, st, n_sched, t, t + WINDOW_SLOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy_us = sum(k[0] for k in kern)
    n = WINDOW_SLOTS
    say(f"[window] {n} slots from {t}: {wall / n * 1e3:.3f} ms/slot wall, "
        f"device busy {busy_us / 1e6 / wall:.4f}, "
        f"{sum(k[1] for k in kern) / n:.1f} kernels/slot, "
        f"{busy_us / n:.1f} us/slot of device time")
    for us, cnt, key in kern[:8]:
        say(f"[window]   {us / n:8.2f} us/slot {cnt / n:6.1f}/slot "
            f"{key[:90]}")
    per_launch = {}
    for name in ("priority_arbiter", "srpt_topk"):
        hits = [k for k in kern if f"{name}_kernel" in k[2]]
        check(len(hits) == 1, f"profiler shows no single {name} kernel")
        us, cnt, _ = hits[0]
        per_launch[name] = us / cnt / 1e3
        say(f"[window] {name}: {cnt / n:.0f} launches/slot, "
            f"{us / cnt:.2f} us device time per launch")
    return per_launch


# ---------------------------------------------------------------- main -----

def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; chip_smoke.py runs the port on a card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"FAIL: {ROOT / 'src' / 'repro_torch'} missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        phase_card()
        err, perf = phase_kernels()
        phase_goldens()
        launches = phase_full()
        device_ms = phase_window()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    replaces = {"priority_arbiter": "src/repro/kernels/arbiter/kernel.py:67",
                "srpt_topk": "src/repro/kernels/arbiter/kernel.py:139"}
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/arbiter/csrc/arbiter.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": perf[name]["ms"],
         "plain_ms": perf[name]["plain_ms"],
         "bound_ms": perf[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": perf[name]["library_ms"],
         "device_ms_per_launch": device_ms[name]}
        for name in ("priority_arbiter", "srpt_topk")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
