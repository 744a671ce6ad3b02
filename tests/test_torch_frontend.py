"""The port's numpy front end equals the JAX package's, exactly: message
tables, Homa's priority allocation and PIAS thresholds for W1-W5 over
three seeds."""
import numpy as np
import pytest

from repro.core import priorities as jprio
from repro.core import workloads as jwl
from repro_torch.core import priorities as tprio
from repro_torch.core import workloads as twl

WORKLOADS = ["W1", "W2", "W3", "W4", "W5"]
SEEDS = [0, 1, 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_frontend_matches_jax(workload, seed):
    kw = dict(n_hosts=16, load=0.7, n_messages=400, slot_bytes=256,
              seed=seed)
    a = jwl.make_messages(workload, **kw)
    b = twl.make_messages(workload, **kw)
    for f in ("src", "dst", "size", "arrival_slot"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.workload, a.load, a.slot_bytes) == \
        (b.workload, b.load, b.slot_bytes)

    ja = jprio.allocate_priorities(a.size, unsched_limit=38 * 256)
    ta = tprio.allocate_priorities(b.size, unsched_limit=38 * 256)
    assert (ja.n_prios, ja.n_unsched, ja.cutoffs, ja.unsched_bytes_frac) \
        == (ta.n_prios, ta.n_unsched, ta.cutoffs, ta.unsched_bytes_frac)
    np.testing.assert_array_equal(ja.unsched_prio(a.size),
                                  ta.unsched_prio(b.size))
    assert jprio.pias_thresholds(a.size, 8) == \
        tprio.pias_thresholds(b.size, 8)


def test_sample_sizes_rejects_unknown_workload():
    with pytest.raises(ValueError, match="available workloads"):
        twl.sample_sizes("W9", 4, np.random.default_rng(0))
