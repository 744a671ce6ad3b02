"""Leaf-spine fabric demo on the PyTorch port: an oversubscribed incast,
homa vs basic. The port's counterpart of ``examples/fabric_incast.py``,
with the same output.

Builds the paper's Fig. 14 shape — repeated fan-in bursts into one
receiver, Poisson background underneath — on a 16-host / 4-rack fabric
with 2:1 TOR-uplink oversubscription, and prints how each protocol's
small-message tail and per-tier queues hold up.

    PYTHONPATH=src python examples/torch_fabric_incast.py [--device cpu]
        [--backend fused] [--bursts 8] [--background 600]
        [--max-slots 16000]

On a CUDA card by default (the staged ``cuda`` kernel backend);
``--device cpu`` runs the plain versions. The defaults are the JAX
example's sizes.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (FabricConfig, SimConfig,  # noqa: E402
                              scenarios, simulate)


def protocol_line(proto, r) -> str:
    """One protocol's line (a port or a JAX package ``SimResult``)."""
    s = r.summary()
    f = s["fabric"]
    return (f"{proto:6s} p99 small {s['p99_small']:6.2f}   "
            f"complete {r.n_complete}/{r.n_messages}   "
            f"downlink qmax {s['q_max_bytes'] / 1024:6.1f} KB   "
            f"uplink qmax {f['up_q_max_bytes'] / 1024:6.1f} KB   "
            f"lost {r.lost_chunks}")


def run(argv=None) -> list[str]:
    """The example's printed lines, each printed as it is made."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--bursts", type=int, default=8)
    ap.add_argument("--background", type=int, default=600,
                    help="background (W2) messages")
    ap.add_argument("--max-slots", type=int, default=16_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="cuda (staged kernels, the card's default), fused "
                         "or reference")
    a = ap.parse_args(argv)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    tbl = scenarios.incast(12, 2048, n_hosts=16, n_bursts=a.bursts,
                           period_slots=1500, background="W2",
                           background_load=0.5, n_background=a.background,
                           seed=2)
    fab = FabricConfig(racks=4, oversub=2.0, up_cap=1024)
    say(f"topology: {fab.racks} racks x {fab.rack_size(16)} hosts, "
        f"{fab.n_uplinks(16)} uplinks/TOR (oversub {fab.oversub}:1)")
    say(f"traffic: {len(tbl.size)} messages "
        f"(12-way incast bursts of 2 KB + W2 background)\n")
    for proto in ("homa", "basic"):
        cfg = SimConfig(protocol=proto, n_hosts=16, max_slots=a.max_slots,
                        ring_cap=1024, fabric=fab, device=a.device,
                        backend=a.backend)
        say(protocol_line(proto, simulate(cfg, tbl)))
    say("\nHoma's wire priorities shield small messages at BOTH queueing"
        "\ntiers; basic funnels everything through one FIFO level.")
    return lines


if __name__ == "__main__":
    run()
