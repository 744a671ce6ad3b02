#!/usr/bin/env python3
"""How often a profiler window loses a kernel record, on one CUDA card,
with and without the marker launches ``chip_smoke.py``'s windows open
with (ROADMAP C6).

    python3 scripts/torch_profiler_c6.py [--procs 10] [--parallel 2]
        [--windows 6] [--models whisper,vision,stablelm] [--history 20]
        [--busy 3] [--no-markers]

Runs ``--procs`` fresh processes, ``--parallel`` at a time, beside
``--busy`` CPU-bound processes (the dry-run cells that run beside
``chip_smoke.py``'s phases 12-13). Each first takes ``--history`` short
profiler sessions (the earlier phases' windows), then for each model
the prefill windows of ``chip_smoke.py``'s phases 13b (Whisper-small
whole), 13c (Llama-3.2-Vision cut to one block) and 15 (StableLM-12B
whole; one process at a time), at their full-width shapes and random
weights from seed 0: ``--windows`` windows of device activity only with
0.5 s of idle trace either side, every second one opening with
``chip_smoke.MARKERS`` marker launches as ``chip_smoke._window`` takes
them (none with ``--no-markers``), then one window without markers with
CPU activity too. In each window the attention calls are logged in
order, and every view of the profiler (``key_averages()``,
``events()``, kineto's raw events) is held to them by
``chip_smoke._launch_records``, which writes the window's trace under
``chiprun_out/`` on a shortfall and names the missing launch; every
kernel's records are counted by name. In the window with CPU activity
every kernel launch of the runtime (its correlation id) is matched to a
kernel record, whatever the kernel.

Each process writes ``chiprun_out/c6/proc_<i>.json`` (and its standard
error beside it); the parent prints, per model, the windows and the
processes that lost an attention record, or any record of the prefill,
with and without the markers, the markers' records, and the launches
the CPU-activity windows recorded no kernel for.
"""
from __future__ import annotations

import argparse
import contextlib
import fcntl
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "c6"
KERNEL = "flash_attention_tc_kernel"
MODELS = ("whisper", "vision", "stablelm")
MARKERS = 256                   # chip_smoke.MARKERS
MARKER_NAME = "spin_kernel"     # chip_smoke.MARKER
DEVICE = "cuda"


def _model(name, dev):
    """(tag, cfg, params, tokens, keyword inputs) of a model at the
    shapes of chip_smoke's phases 13b, 13c and 15."""
    import dataclasses
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    run = {"whisper": cs.WHISPER, "vision": cs.VISION,
           "stablelm": cs.STABLELM}[name]
    cfg = get_config(run["arch"])
    if name == "vision":
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    gen = torch.Generator(dev).manual_seed(run["seed"])
    params = init_params(M.model_defs(cfg), gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (run["batch"], run["seq"]),
                           generator=gen, device=dev)
    kw = {}
    if name != "stablelm":
        key, n = (("enc_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder
                  else ("img_embeds", cfg.num_image_tokens))
        kw[key] = torch.randn((run["batch"], n, cfg.d_model), generator=gen,
                              device=dev).bfloat16()
    return cfg, params, tokens, kw


def _unmatched_launches(prof, path: Path) -> dict:
    """A window with CPU activity: the runtime's kernel launches whose
    correlation id has no kernel record, by the exported trace (kept
    under ``path`` when one is missing)."""
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    launched = {e["args"]["correlation"]: e["name"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    recorded = {e["args"].get("correlation") for e in ev
                if e.get("cat") == "kernel"}
    lost = sorted(c for c in launched if c not in recorded)
    if not lost:
        path.unlink()
    return {"launches": len(launched), "kernel_records": len(recorded),
            "unmatched": len(lost),
            "unmatched_calls": [launched[c] for c in lost[:10]]}


def _history(n: int, dev) -> None:
    """``n`` short profiler sessions, as the phases before 13 take them:
    each a few PyTorch kernels and one attention launch."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.attention.kernel import flash_attention
    q = torch.randn((1, 256, 4, 64), device=dev).bfloat16()
    for _ in range(n):
        cs._window(lambda: flash_attention(q, q, q) + q.float().sum(),
                   cpu=False, idle=0.01)


def child(i: int, models, windows: int, history: int,
          markers: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import chip_smoke as cs
    from repro_torch.models import model as M
    dev = torch.device(DEVICE)
    out = {"proc": i, "models": {}}
    t0 = time.perf_counter()
    _history(history, dev)
    out["history_s"] = time.perf_counter() - t0
    for name in models:
        with _one_at_a_time(name):
            out["models"][name] = _windows(cs, M, name, dev, i, windows,
                                           markers)
    return out


@contextlib.contextmanager
def _one_at_a_time(name: str):
    """StableLM's 28 GB runs in one process at a time (two at once, with
    the caching allocator's spare, do not fit 80 GB)."""
    if name != "stablelm":
        yield
        return
    with open(OUT / "stablelm.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _windows(cs, M, name, dev, i, windows, markers) -> dict:
    """One model's windows in process ``i``."""
    import torch
    t0 = time.perf_counter()
    cfg, params, tokens, kw = _model(name, dev)
    rows = []
    with torch.inference_mode():
        M.forward_prefill(cfg, params, tokens, **kw)     # warm-up
        for w in range(windows + 1):
            marker = markers and w % 2 == 1 and w < windows
            cpu = w == windows
            with cs._attention_calls() as calls:
                _, wall, prof = cs._window(
                    lambda: M.forward_prefill(cfg, params, tokens, **kw),
                    cpu=cpu, idle=0.5, marker=marker)
            rec = cs._launch_records(prof, KERNEL, calls,
                                     f"{name}_p{i}_w{w}")
            names = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    names[e.name()] = names.get(e.name(), 0) + 1
            if cpu:
                rec["runtime"] = _unmatched_launches(
                    prof, OUT / f"cpu_{name}_p{i}.json")
            rec.update(marker=marker, cpu=cpu, wall_s=wall,
                       kernels=sum(names.values()), names=names)
            rows.append(rec)
            print(f"[c6 proc {i}] {name} window {w}: "
                  f"{ {k: v for k, v in rec.items() if k != 'names'} }",
                  flush=True)
    del params, tokens, kw
    torch.cuda.empty_cache()
    return {"windows": rows, "seconds": time.perf_counter() - t0}


def _missed(rec: dict, view: str) -> bool:
    return rec[view] != rec["calls"]


def _summary(results: list, models) -> None:
    """Print, per model, the windows that lost records."""
    for name in models:
        for marker in (False, True):
            wins = [(r["proc"], w) for r in results
                    for w in r["models"][name]["windows"]
                    if w["marker"] == marker]
            short = sorted({p for p, w in wins if _missed(w, "kineto")})
            print(f"[c6] {name} {'with' if marker else 'without'} markers: "
                  f"{sum(_missed(w, 'kineto') for _, w in wins)} of "
                  f"{len(wins)} windows lost an attention record, in "
                  f"processes {short} of {len(results)}; all views agree: "
                  f"{all(w['key_averages'] == w['events'] == w['kineto'] for _, w in wins)}")
            if not marker:
                print(f"[c6] {name} CPU-activity windows: launches with no "
                      f"kernel record "
                      f"{[(p, w['runtime']['unmatched']) for p, w in wins if w['cpu']]}")
            else:
                print(f"[c6] {name} marker records per window (of "
                      f"{MARKERS}): {[(p, w['markers']) for p, w in wins]}")
        # records lost by name: each window against the most its process
        # recorded of that name in a window of the same kind
        for marker in (False, True):
            hit, n_win = [], 0
            for r in results:
                ws = r["models"][name]["windows"]
                same = [w for w in ws
                        if w["marker"] == marker and not w["cpu"]]
                n_win += len(same)
                top = {}
                for w in same:
                    for k, n in w["names"].items():
                        top[k] = max(top.get(k, 0), n)
                for w in same:
                    lost = {k[:60]: top[k] - w["names"].get(k, 0)
                            for k in top if w["names"].get(k, 0) < top[k]}
                    if lost:
                        hit.append((r["proc"], ws.index(w), lost))
            prefill = [h for h in hit
                       if any(MARKER_NAME not in k for k in h[2])]
            print(f"[c6] {name} {'with' if marker else 'without'} markers: "
                  f"{len(prefill)} of {n_win} windows lost a record of the "
                  f"prefill, in processes {sorted({h[0] for h in prefill})}"
                  f"; every window that lost one (process, window, lost): "
                  f"{hit}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=10)
    ap.add_argument("--parallel", type=int, default=2)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--history", type=int, default=20,
                    help="short profiler sessions before the models'")
    ap.add_argument("--busy", type=int, default=3,
                    help="CPU-bound processes beside the run")
    ap.add_argument("--no-markers", action="store_true",
                    help="no window opens with the marker launches")
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args(argv)
    models = args.models.split(",")
    OUT.mkdir(parents=True, exist_ok=True)
    if args.child is not None:
        res = child(args.child, models, args.windows, args.history,
                    not args.no_markers)
        (OUT / f"proc_{args.child}.json").write_text(json.dumps(res))
        return 0
    for old in OUT.glob("proc_*"):
        old.unlink()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.attention.kernel import LIBRARY
    LIBRARY.load()                  # built once, before the processes
    t0 = time.perf_counter()
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    todo, running, failed = list(range(args.procs)), [], []
    while todo or running:
        while todo and len(running) < args.parallel:
            i = todo.pop(0)
            err = open(OUT / f"proc_{i}.err", "w")
            cmd = [sys.executable, __file__, "--child", str(i), "--models",
                   args.models, "--windows", str(args.windows),
                   "--history", str(args.history)] \
                + (["--no-markers"] if args.no_markers else [])
            running.append((i, subprocess.Popen(cmd, stderr=err), err))
        time.sleep(1)
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            item[2].close()
            if item[1].returncode != 0:
                failed.append(item[0])
    for p in busy:
        p.kill()
        p.wait()
    results = [json.loads(p.read_text())
               for p in sorted(OUT.glob("proc_*.json"))]
    print(f"[c6] {len(results)} processes in "
          f"{time.perf_counter() - t0:.1f} s; failed {failed}")
    _summary(results, models)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[c6] {smi}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
