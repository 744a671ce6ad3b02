"""The port on the CPU reproduces ``tests/golden/fabric_enabled.json``
(4 racks, 2:1 oversubscribed leaf-spine) bit-exactly for all six
protocols."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import FabricConfig, SimConfig, make_messages, simulate

GOLDEN = Path(__file__).parent / "golden" / "fabric_enabled.json"
ALL_PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("proto", ALL_PROTOS)
def test_port_matches_enabled_golden(golden, proto):
    meta, want = golden["meta"], golden["protocols"][proto]
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                       up_cap=meta["up_cap"])
    cfg = SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    fabric=fab, device="cpu")
    r = simulate(cfg, tbl)
    assert [int(x) for x in r.completion] == want["completion"]
    assert r.lost_chunks == want["lost_chunks"]
    assert [int(x) for x in r.q_max_bytes] == want["q_max_bytes"]
    assert [int(x) for x in r.prio_drained_bytes] \
        == want["prio_drained_bytes"]
    assert [round(float(x), 8) for x in r.busy_frac] == want["busy"]
    assert [int(x) for x in r.tor_up_q_max_bytes] \
        == want["tor_up_q_max_bytes"]
    assert r.tor_up_lost_chunks == want["tor_up_lost_chunks"]
    assert r.fabric["racks"] == meta["racks"]
