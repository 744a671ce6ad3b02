"""The port reproduces ``benchmarks/baselines/hostmodel_smoke.json``
exactly on the CPU: ``benchmarks/hostmodel_figs.py`` ``hostmodel_smoke``,
homa on a size-capped W2 at load 0.5 (400 messages, ``max_bytes``
65536) on 8 hosts with ``ring_cap`` 2048, behind the ``ideal`` and the
``kernel_stack`` host, through ``run_sweep`` with ``max_slots`` =
min(25000, arrival horizon + 20000), as ``benchmarks/common.py``
``sim_sweep`` builds it."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.core import SimConfig, SweepSpec, WorkloadSpec, run_sweep

torch.set_num_threads(1)
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "hostmodel_smoke.json"


def _row(preset: str, r: dict) -> dict:
    """``benchmarks/hostmodel_figs.py``'s ``_row`` of one summary."""
    h = r["host"] or {}
    return dict(
        workload="W2", host=preset,
        p50_all=round(r["p50_all"], 3),
        p99_small=round(r["p99_small"] or 0, 2),
        completion=round(r["completion_rate"], 3),
        tx_busy=round(h.get("tx_busy_frac") or 0, 3),
        tx_defer=round(h.get("tx_defer_frac") or 0, 3),
        rx_stall=round(h.get("rx_stall_frac") or 0, 3),
        rx_q_max=h.get("rx_q_max_chunks") or 0)


@pytest.fixture(scope="module")
def rows():
    tbl = WorkloadSpec(kind="poisson", workload="W2", load=0.5,
                       n_messages=400, max_bytes=65_536).build(
        n_hosts=8, slot_bytes=256)
    ms = min(25_000, int(tbl.arrival_slot.max()) + 20_000)
    out = []
    for preset in ("ideal", "kernel_stack"):
        cfg = SimConfig(n_hosts=8, slot_bytes=256, protocol="homa",
                        ring_cap=2048, host=preset, max_slots=ms,
                        device="cpu")
        (r,) = run_sweep(cfg, SweepSpec(tables=[tbl]))
        out.append(_row(preset, r.summary(warmup_frac=0.1)))
    out[1]["gap_p50"] = round(out[1]["p50_all"] / out[0]["p50_all"], 3)
    out[0]["gap_p50"] = 1.0
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["ideal", "kernel_stack"])
def test_hostmodel_smoke_reproduces_the_baseline(rows, i):
    assert rows[i] == json.loads(BASELINE.read_text())[i]
