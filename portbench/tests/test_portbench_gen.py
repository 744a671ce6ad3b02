"""The benchmark's frozen traffic generator draws the port's tables bit
for bit."""
import numpy as np
import pytest

import portbench_tiny  # noqa: F401
from portbench.harness import load_module
from repro_torch.core import make_messages

poisson = load_module("gen", "poisson")


@pytest.mark.parametrize("workload", sorted(poisson.WORKLOAD_BINS))
def test_tables_match_the_port(workload):
    seed = poisson.table_seeds(2 ** 31 + 977, 3)[2]
    got = poisson.make_table(workload, n_hosts=16, load=0.7, n_messages=300,
                             slot_bytes=256, seed=seed)
    want = make_messages(workload, n_hosts=16, load=0.7, n_messages=300,
                         slot_bytes=256, seed=seed)
    for k in ("src", "dst", "size", "arrival_slot"):
        a, b = got[k], getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_grid_order_and_seeds():
    mix = {"workload": "W3", "loads": [0.5, 0.9], "seeds_per_load": 3,
           "n_messages": 50}
    cfg = {"n_hosts": 16, "slot_bytes": 256}
    grid = poisson.tables(mix, cfg, 12)
    assert [t["load"] for t in grid] == [0.5] * 3 + [0.9] * 3
    # one seed index is one size draw at every load; seeds differ
    assert np.array_equal(grid[1]["size"], grid[4]["size"])
    assert not np.array_equal(grid[0]["size"], grid[1]["size"])
    assert poisson.tables(mix, cfg, 12)[5]["arrival_slot"].tolist() == \
        grid[5]["arrival_slot"].tolist()
    assert poisson.table_seeds(12, 3) != poisson.table_seeds(13, 3)
