"""The port on the CPU reproduces ``tests/golden/fabric_disabled.json``
(the single-switch simulator) bit-exactly for all six protocols."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import SimConfig, make_messages, simulate

GOLDEN = Path(__file__).parent / "golden" / "fabric_disabled.json"
ALL_PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("proto", ALL_PROTOS)
def test_port_matches_disabled_golden(golden, proto):
    meta, want = golden["meta"], golden["protocols"][proto]
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    cfg = SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                    max_slots=meta["max_slots"], ring_cap=meta["ring_cap"],
                    device="cpu")
    assert cfg.backend == "reference"
    r = simulate(cfg, tbl)
    assert [int(x) for x in r.completion] == want["completion"]
    assert r.lost_chunks == want["lost_chunks"]
    assert [int(x) for x in r.q_max_bytes] == want["q_max_bytes"]
    assert [int(x) for x in r.prio_drained_bytes] \
        == want["prio_drained_bytes"]
    assert [round(float(x), 8) for x in r.busy_frac] == want["busy"]
    assert r.fabric is None and r.tor_up_busy_frac is None
