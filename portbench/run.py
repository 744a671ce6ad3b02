"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``; ``portbench/harness.py`` says how its files are
found. The run needs a CUDA card (the cell's ``chips`` of them) and
never falls back to the CPU. Its last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each number compared beside its limit); the same checks are the last
lines of standard error. It exits with another code than 0, and prints
no result, without a card, when the program cannot be imported, and
when JAX or the JAX package (``repro``) is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    plan = harness.plan(harness.load_benchmark(), args.workload)
    harness.require_cards(plan.cell["chips"])
    result = plan.runner.run(plan, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda",
                             t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 1
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
