#!/usr/bin/env python3
"""Hold the lossy cell's plain reference (``portbench/reference/
lossy_sim.py``) to the JAX package's fault golden
(``tests/golden/faults_enabled.json``) without JAX.

    python3 scripts/torch_lossy_golden.py --part full --device cuda \\
        [--out lossy_golden.json]

``--part full`` steps the golden's 144-host point (W3 at load 0.8, 8000
messages, 4000 slots, flowlet routing, every fault kind) through the
reference and compares every message's completion slot and the
golden's counter totals exactly; ``--part small`` replays the runs of
the 8-host part that the reference models (the CPU test
``portbench/tests/test_portbench_lossy.py`` does that too). Prints one
JSON line a run (also written to ``--out``) and exits with 1 where a
run differs. The full point wants the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402
from portbench.gen import poisson  # noqa: E402

GOLDEN = ROOT / "tests" / "golden" / "faults_enabled.json"
MODELED = ("homa-lossy-ecmp", "homa-windows-ecmp", "homa-windows-flowlet",
           "pfabric-lossy-ecmp")


def config(meta: dict, protocol: str, routing: str, fault: dict,
           slots: int) -> dict:
    """A golden run as a benchmark configuration: the lossy cell's, with
    the golden's sizes, fabric and faults."""
    base = json.loads((ROOT / "portbench/configs/"
                       "homa-lossy-leafspine144.json").read_text())
    cfg = dict(base, n_hosts=meta["n_hosts"], slot_bytes=meta["slot_bytes"],
               protocol=protocol, ring_cap=meta["ring_cap"],
               max_slots=slots)
    cfg["fabric"] = dict(base["fabric"], racks=meta["racks"],
                         oversub=meta["oversub"], up_cap=meta["up_cap"],
                         routing=routing, faults=fault)
    return cfg


def table(meta: dict) -> dict:
    return poisson.make_table(meta["workload"], n_hosts=meta["n_hosts"],
                              load=meta["load"],
                              n_messages=meta["n_messages"],
                              slot_bytes=meta["slot_bytes"],
                              seed=meta["seed"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("small", "full"), default="full")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lossy = harness.load_module("reference", "lossy_sim")
    golden = json.loads(GOLDEN.read_text())[args.part]
    meta = golden["meta"]
    if args.part == "full":
        jobs = [("full", config(meta, meta["protocol"], meta["routing"],
                                golden["faults"], meta["slots"]),
                 golden["completion"], golden["counters"])]
    else:
        jobs = [(r["name"], config(meta, r["protocol"], r["routing"],
                                   r["faults"], meta["max_slots"]),
                 r["completion"], {"f_lost": r["fault_lost_chunks"],
                                   "retx": sum(r["retx_chunks"])})
                for r in golden["runs"] if r["name"] in MODELED]
    lines, ok = [], True
    for name, cfg, completion, counters in jobs:
        t0 = time.perf_counter()
        st = lossy.final_state(cfg, table(meta), args.device)
        got = {k: int(st[k].sum()) for k in counters}
        comp = st["completion"].tolist()
        same = comp == completion and got == counters
        ok &= same
        lines.append(json.dumps({
            "run": name, "equal": same,
            "completions_differ": sum(a != b for a, b in
                                      zip(comp, completion)),
            "counters": got, "golden_counters": counters,
            "rw_resend": int(st["rw_resend"]),
            "rw_timeout": int(st["rw_timeout"]),
            "complete": sum(c >= 0 for c in comp), "messages": len(comp),
            "device": args.device,
            "seconds": time.perf_counter() - t0}))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
