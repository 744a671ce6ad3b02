"""Run the paper-faithful Homa packet-level simulator of the PyTorch port
and print a miniature Figure-12: 99p slowdown by message size, for any
registered protocols. The port's counterpart of
``examples/homa_network_sim.py``, flag for flag, with the same output.

    PYTHONPATH=src python examples/torch_homa_network_sim.py \
        [--workload W3] [--protocols homa,basic,ndp] [--device cpu]
        [--backend fused] [--max-slots 60000]

On a CUDA card by default (the staged ``cuda`` kernel backend: the
priority arbiter and the SRPT top-K each slot); ``--device cpu`` runs
the plain versions.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (SimConfig, make_messages,  # noqa: E402
                              registered_protocols, simulate)


def protocol_lines(proto, res) -> list[str]:
    """The lines printed for one protocol's result (a port or a JAX
    package ``SimResult``)."""
    b = res.percentiles_by_size(99, n_buckets=8)
    out = [f"\n{proto}: {res.n_complete}/{res.n_messages} complete, "
           f"priorities: {res.alloc.n_unsched} unsched / "
           f"{res.alloc.n_sched} sched, cutoffs {res.alloc.cutoffs}",
           "  size_bytes   p99_slowdown   median"]
    for sz, p, m in zip(b["sizes"], b["p"], b["median"]):
        bar = "#" * min(int(p * 2), 60)
        out.append(f"  {int(sz):>9}   {p:>7.2f} {bar}")
    return out


def comparison_lines(results: dict) -> list[str]:
    """Homa's small-message tail against basic's, when both ran."""
    if "homa" not in results or "basic" not in results:
        return []
    h, bsc = results["homa"], results["basic"]
    ph = h.percentile(99, h.done & (h.size_bytes < 1000))
    pb = bsc.percentile(99, bsc.done & (bsc.size_bytes < 1000))
    if ph is None or pb is None:        # e.g. W5 has no sub-1KB messages
        return ["\nno completed sub-1KB messages to compare"]
    return [f"\nsmall-message p99: homa {ph:.2f} vs basic {pb:.2f} "
            f"({pb / ph:.1f}x better)"]


def run(argv=None) -> list[str]:
    """The example's printed lines, each printed as it is made."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="W3")
    ap.add_argument("--load", type=float, default=0.8)
    ap.add_argument("--messages", type=int, default=1500)
    ap.add_argument("--protocols", default="homa,basic",
                    help=f"comma-separated; registered: "
                         f"{','.join(registered_protocols())}")
    ap.add_argument("--max-slots", type=int, default=60_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="cuda (staged kernels, the card's default), fused "
                         "or reference")
    a = ap.parse_args(argv)
    lines = []

    def say(*ls):
        for line in ls:
            print(line, flush=True)
            lines.append(line)

    tbl = make_messages(a.workload, n_hosts=8, load=a.load,
                        n_messages=a.messages, slot_bytes=256, seed=1)
    say(f"workload {a.workload} @ {a.load:.0%} load, "
        f"{a.messages} messages, 8 hosts")
    results = {}
    for proto in a.protocols.split(","):
        cfg = SimConfig(n_hosts=8, protocol=proto, max_slots=a.max_slots,
                        ring_cap=2048, device=a.device, backend=a.backend)
        results[proto] = simulate(cfg, tbl)
        say(*protocol_lines(proto, results[proto]))
    say(*comparison_lines(results))
    return lines


if __name__ == "__main__":
    run()
