"""Shared pieces of the benchmark's CPU tests: the repo on the import
path, one torch thread, and cells cut to a size a test run can hold."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402


@pytest.fixture
def one_thread():
    """One torch thread: the CPU tests' small ops run many times faster
    on one thread than on a shared machine's many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_plan(cell: str, hosts: int = 16, slots: int = 300, msgs: int = 200,
              loads=(0.6, 0.9), per: int = 2):
    """Cell ``cell`` of the repo's benchmark cut to ``hosts`` hosts in 2
    racks, ``msgs`` messages and ``slots`` slots a run, ``per`` seeds at
    each of ``loads``, every run checked."""
    p = harness.plan(harness.load_benchmark(), cell)
    c = dict(p.config, n_hosts=hosts, max_slots=slots)
    c["fabric"] = dict(c["fabric"], racks=2)
    p.config = c
    p.traffic = dict(p.traffic, n_messages=msgs, seeds_per_load=per,
                     loads=list(loads), check_runs_per_load=per,
                     chunk_slots=slots // 2 + 7)
    return p
