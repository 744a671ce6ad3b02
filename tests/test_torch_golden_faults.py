"""The port on the CPU reproduces the ``"small"`` part of
``tests/golden/faults_enabled.json`` (written by the JAX package through
``scripts/make_torch_fault_golden.py``) bit-exactly: all six protocols
under Bernoulli and Gilbert-Elliott loss, and homa under a failed uplink
and a failed TOR with each routing policy."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import FabricConfig, SimConfig, make_messages, simulate

GOLDEN = Path(__file__).parent / "golden" / "faults_enabled.json"
G = json.loads(GOLDEN.read_text())["small"]

torch.set_num_threads(1)


def replay(meta, run, backend="reference", device="cpu"):
    """One golden run through the port; returns the golden's fields."""
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                       up_cap=meta["up_cap"], routing=run["routing"],
                       faults=run["faults"])
    cfg = SimConfig(protocol=run["protocol"], n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=fab, backend=backend, device=device)
    r = simulate(cfg, tbl)
    return {"completion": [int(x) for x in r.completion],
            "retx_chunks": [int(x) for x in r.retx_chunks],
            "msg_lost_chunks": [int(x) for x in r.msg_lost_chunks],
            "fault_lost_chunks": int(r.fault_lost_chunks),
            "lost_chunks": int(r.lost_chunks),
            "tor_up_lost_chunks": int(r.tor_up_lost_chunks),
            "busy": [round(float(x), 8) for x in r.busy_frac]}


@pytest.mark.parametrize("run", G["runs"], ids=[r["name"] for r in G["runs"]])
def test_port_matches_fault_golden(run):
    got = replay(G["meta"], run)
    bad = [k for k in got if got[k] != run[k]]
    assert not bad, f"{run['name']}: differs from the golden in {bad}"
    assert got["fault_lost_chunks"] > 0 and sum(got["retx_chunks"]) > 0
