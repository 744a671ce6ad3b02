"""The control of the comparison that decides a sweep cell's ``correct``.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

For each seed: the cell's grid, the reference over the runs a run of
the cell checks, and the control over the same runs in the program's
place — the reference with both drain tiers one slot early, past the
configuration's stated link delays (``early=1`` in
``portbench/reference/plain_sim.py``) — judged as a run judges the
program. A sound program reads 0 mismatched integers; the control has
to read more for the comparison to be worth anything. One JSON line a
seed. Needs the card, as the cell does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    plan = harness.plan(harness.load_benchmark(), args.workload)
    harness.require_cards(plan.cell["chips"])
    cfg, mix, ref = plan.config, plan.traffic, plan.reference
    for seed in args.seeds:
        t0 = time.perf_counter()
        tables = plan.generator.tables(mix, cfg, seed)
        check = plan.runner.check_runs(mix, seed)
        rows = {}
        for early in (0, 1):
            rows[early] = ref.run(cfg, tables, mix["streaming"],
                                  mix["chunk_slots"], mix["shared_alloc"],
                                  check, "cuda", early=early)
        bad = [plan.runner.mismatches(c, w)
               for c, w in zip(rows[1], rows[0])]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_mismatched_ints": sum(bad),
                          "runs_wrong": sum(b > 0 for b in bad),
                          "runs": len(check), "limit": 0,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
