"""Run one traced simulation of the PyTorch port and export its timeline
(DESIGN.md §8): the port's counterpart of ``scripts/export_trace.py``,
flag for flag, with the same output.

    PYTHONPATH=src python scripts/torch_export_trace.py \
        --protocol homa --workload W2 --load 0.6 --out trace.json \
        [--device cpu] [--backend fused]

Writes a Chrome trace-event / Perfetto JSON (open it at
https://ui.perfetto.dev — counter tracks carry the strided queue /
grant / priority series, the "protocol events" process carries the
ledger as instant events per host, and the "messages" process shows
each completed message as a duration slice). ``--timeseries`` instead
writes the raw JSON time-series form. On a CUDA card by default (the
staged ``cuda`` kernel backend); ``--device cpu`` runs the plain
versions.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (FabricConfig, SimConfig,  # noqa: E402
                              TraceConfig, make_messages, simulate)
from repro_torch.core.telemetry import EV_NAMES  # noqa: E402


def run(argv=None) -> dict:
    """Simulate, write ``--out``; returns the printed ``line``, the
    written JSON object (``trace``) and the exit code (``rc``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocol", default="homa")
    ap.add_argument("--workload", default="W2")
    ap.add_argument("--load", type=float, default=0.6)
    ap.add_argument("--n-hosts", type=int, default=16)
    ap.add_argument("--n-messages", type=int, default=600)
    ap.add_argument("--max-slots", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--racks", type=int, default=None,
                    help="enable the leaf-spine fabric with this many "
                         "racks (default: single switch)")
    ap.add_argument("--oversub", type=float, default=2.0)
    ap.add_argument("--up-loss", type=float, default=0.0,
                    help="Bernoulli uplink chunk-loss rate (fabric only)")
    ap.add_argument("--stride", type=int, default=16,
                    help="slots per time-series sample window")
    ap.add_argument("--ledger-cap", type=int, default=4096)
    ap.add_argument("--timeseries", action="store_true",
                    help="write the JSON time-series form instead of "
                         "Perfetto")
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="cuda (staged kernels, the card's default), fused "
                         "or reference")
    args = ap.parse_args(argv)

    fabric = None
    if args.racks:
        faults = dict(up_loss=args.up_loss) if args.up_loss > 0 else None
        fabric = FabricConfig(racks=args.racks, oversub=args.oversub,
                              faults=faults)
    elif args.up_loss > 0:
        print("--up-loss needs --racks (losses live on the fabric tier)",
              file=sys.stderr)
        return {"line": None, "trace": None, "rc": 2}

    cfg = SimConfig(n_hosts=args.n_hosts, protocol=args.protocol,
                    max_slots=args.max_slots, fabric=fabric,
                    trace=TraceConfig(stride=args.stride,
                                      ledger_cap=args.ledger_cap),
                    device=args.device, backend=args.backend)
    tbl = make_messages(args.workload, n_hosts=args.n_hosts,
                        load=args.load, n_messages=args.n_messages,
                        slot_bytes=cfg.slot_bytes, seed=args.seed)
    r = simulate(cfg, tbl)
    tr = r.trace

    if args.timeseries:
        trace = tr.to_timeseries_json()
        with open(args.out, "w") as f:
            json.dump(trace, f)
    else:
        trace = tr.to_perfetto(args.out)

    kinds = {}
    for k in tr.events[:, 1].tolist():
        name = EV_NAMES.get(int(k), str(k))
        kinds[name] = kinds.get(name, 0) + 1
    line = (f"wrote {args.out}: {r.n_complete}/{r.n_messages} messages, "
            f"{len(tr.sample_slots)} samples @ stride {tr.stride}, "
            f"{tr.n_events} ledger rows ({tr.events_dropped} dropped) "
            f"{kinds}")
    print(line)
    return {"line": line, "trace": trace, "rc": 0}


if __name__ == "__main__":
    sys.exit(run()["rc"])
