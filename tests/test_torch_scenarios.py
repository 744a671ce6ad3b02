"""The port's traffic front end (``core/workloads.py``, ``core/scenarios.py``)
against the JAX package's, on the CPU.

Every ``WorkloadSpec`` kind, the Poisson incast overlay and
``merge_tables`` must build the JAX package's tables exactly (same numpy
draws in the same order), over several seeds; the wrappers must equal
``WorkloadSpec.build``; the failure-scenario helpers must compose as
JAX's do. Also ``bytes_weighted_unsched_fraction`` and
``slowdown_percentiles``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import SimConfig as JConfig
from repro.core import WorkloadSpec as JSpec
from repro.core import make_messages as jmake
from repro.core import scenarios as jscen
from repro.core import simulate as jsimulate
from repro.core import slowdown_percentiles as jslowdown_percentiles
from repro.core.workloads import bytes_weighted_unsched_fraction as jbwuf
from repro_torch.core import (FabricConfig, FaultConfig, SimConfig,
                              WorkloadSpec, make_messages, scenarios,
                              simulate, slowdown_percentiles)
from repro_torch.core.workloads import bytes_weighted_unsched_fraction

torch.set_num_threads(1)
SEEDS = [0, 3, 11]


def _eq(a, b):
    for f in ("src", "dst", "size", "arrival_slot"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.workload, a.load, a.slot_bytes) \
        == (b.workload, b.load, b.slot_bytes)


SPECS = [
    dict(kind="poisson", workload="W2", load=0.6, n_messages=300),
    dict(kind="poisson", workload="W1", load=0.5, n_messages=400,
         max_bytes=5000),
    dict(kind="poisson", workload="W2", load=0.6, n_messages=300,
         incast=(4, 2000, 500)),
    dict(kind="poisson", workload="W3", load=0.8, n_messages=200,
         incast=(7, 30_000, 50)),
    dict(kind="incast", fan_in=5, burst_bytes=20_000, n_bursts=3),
    dict(kind="incast", fan_in=7, burst_bytes=4000, dst=3, n_bursts=4,
         period_slots=300, first_slot=100, background="W1",
         background_load=0.2, n_background=100),
    dict(kind="hotspot", workload="W2", load=0.5, n_messages=200,
         hot_fraction=0.6, n_hot=2),
    dict(kind="hotspot", workload="W4", load=0.7, n_messages=150,
         hot_fraction=1.0, n_hot=1, max_bytes=100_000),
    dict(kind="shuffle", bytes_per_pair=5000),
    dict(kind="shuffle", bytes_per_pair=800, spread_slots=400),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spec", SPECS,
                         ids=[f"{s['kind']}{i}" for i, s in enumerate(SPECS)])
def test_every_spec_kind_builds_jaxs_table(spec, seed):
    kw = dict(spec, seed=seed)
    _eq(WorkloadSpec(**kw).build(n_hosts=8, slot_bytes=256),
        JSpec(**kw).build(n_hosts=8, slot_bytes=256))


@pytest.mark.parametrize("seed", SEEDS)
def test_wrappers_are_spec_build_and_match_jax(seed):
    pairs = [
        (make_messages("W2", n_hosts=8, load=0.6, n_messages=300,
                       slot_bytes=256, seed=seed, max_bytes=100_000,
                       incast=(4, 2000, 500)),
         jmake("W2", n_hosts=8, load=0.6, n_messages=300, slot_bytes=256,
               seed=seed, max_bytes=100_000, incast=(4, 2000, 500))),
        (scenarios.incast(5, 20_000, n_hosts=8, n_bursts=3, seed=seed,
                          background="W1", background_load=0.2,
                          n_background=100),
         jscen.incast(5, 20_000, n_hosts=8, n_bursts=3, seed=seed,
                      background="W1", background_load=0.2,
                      n_background=100)),
        (scenarios.hotspot("W2", n_hosts=8, load=0.5, n_messages=200,
                           seed=seed, hot_fraction=0.6, n_hot=2),
         jscen.hotspot("W2", n_hosts=8, load=0.5, n_messages=200,
                       seed=seed, hot_fraction=0.6, n_hot=2)),
        (scenarios.shuffle(n_hosts=8, bytes_per_pair=5000,
                           spread_slots=400, seed=seed),
         jscen.shuffle(n_hosts=8, bytes_per_pair=5000, spread_slots=400,
                       seed=seed)),
    ]
    for port, jax_ in pairs:
        _eq(port, jax_)
    _eq(pairs[2][0], WorkloadSpec(kind="hotspot", workload="W2", load=0.5,
                                  n_messages=200, seed=seed,
                                  hot_fraction=0.6,
                                  n_hot=2).build(n_hosts=8))


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_tables_matches_jax(seed):
    a = make_messages("W1", n_hosts=8, load=0.4, n_messages=120,
                      slot_bytes=256, seed=seed)
    b = scenarios.shuffle(n_hosts=8, bytes_per_pair=3000, spread_slots=900,
                          seed=seed)
    ja = jmake("W1", n_hosts=8, load=0.4, n_messages=120, slot_bytes=256,
               seed=seed)
    jb = jscen.shuffle(n_hosts=8, bytes_per_pair=3000, spread_slots=900,
                       seed=seed)
    m = scenarios.merge_tables(a, b, workload="mix", load=0.4)
    _eq(m, jscen.merge_tables(ja, jb, workload="mix", load=0.4))
    assert len(m.size) == len(a.size) + len(b.size)
    assert (np.diff(m.arrival_slot) >= 0).all()
    c = make_messages("W1", n_hosts=8, load=0.4, n_messages=10,
                      slot_bytes=512, seed=seed)
    with pytest.raises(ValueError, match="different slot sizes"):
        scenarios.merge_tables(a, c, workload="x", load=0.4)


@pytest.mark.parametrize("make, match", [
    (lambda m: m.WorkloadSpec(kind="uniform"), "kind"),
    (lambda m: m.WorkloadSpec(kind="poisson", load=0.5), "workload"),
    (lambda m: m.WorkloadSpec(kind="hotspot", workload="W2"), "load"),
    (lambda m: m.WorkloadSpec(kind="incast", burst_bytes=1000), "fan_in"),
    (lambda m: m.WorkloadSpec(kind="shuffle"), "bytes_per_pair"),
    (lambda m: m.WorkloadSpec(kind="incast", fan_in=8,
                              burst_bytes=100).build(n_hosts=8), "fan_in"),
    (lambda m: m.WorkloadSpec(kind="hotspot", workload="W1", load=0.5,
                              hot_fraction=1.5).build(n_hosts=8),
     "hot_fraction"),
    (lambda m: m.WorkloadSpec(kind="hotspot", workload="W1", load=0.5,
                              n_hot=8).build(n_hosts=8), "n_hot"),
    (lambda m: m.make_messages("W1", n_hosts=4, load=0.5, n_messages=10,
                               slot_bytes=256, incast=(2, 100, 0)),
     "period_slots"),
])
def test_spec_errors_match_jax(make, match):
    import repro.core as jcore
    import repro_torch.core as core
    for mod in (core, jcore):
        with pytest.raises(ValueError, match=match):
            make(mod)


def test_spec_normalizes_like_jax():
    ws = WorkloadSpec(workload="W1", load=0.5, incast=[4, 2000, 500])
    assert ws.incast == (4, 2000, 500)
    assert ws.with_seed(7).seed == 7 and ws.seed == 0
    assert dataclasses.asdict(ws) == dataclasses.asdict(
        JSpec(workload="W1", load=0.5, incast=[4, 2000, 500]))


@pytest.mark.parametrize("limit", [1, 2000, 9728, 10 ** 9])
def test_bytes_weighted_unsched_fraction_matches_jax(limit):
    sizes = make_messages("W3", n_hosts=8, load=0.5, n_messages=500,
                          slot_bytes=256, seed=4).size
    got = bytes_weighted_unsched_fraction(sizes, limit)
    assert got == jbwuf(sizes, limit)
    assert 0.0 < got <= 1.0


def test_slowdown_percentiles_match_jax():
    tkw = dict(n_hosts=8, load=0.7, n_messages=120, slot_bytes=256, seed=2)
    kw = dict(protocol="homa", n_hosts=8, max_slots=1500, ring_cap=256)
    r = simulate(SimConfig(**kw, device="cpu"), make_messages("W2", **tkw))
    jr = jsimulate(JConfig(**kw), jmake("W2", **tkw))
    for pct, nb in ((99.0, 10), (50.0, 4)):
        got = slowdown_percentiles(r, pct, nb)
        assert got == jslowdown_percentiles(jr, pct, nb)
        legacy = {"size_bytes": r.size_bytes, "slowdown": r.slowdown,
                  "done": r.done}
        assert slowdown_percentiles(legacy, pct, nb) == got


def test_scenario_fault_helpers_compose_as_jaxs():
    fab, jfab = FabricConfig(racks=4, oversub=2.0), \
        JFabric(racks=4, oversub=2.0)
    for mod, f in ((scenarios, fab), (jscen, jfab)):
        lossy = mod.lossy_fabric(f, up_loss=0.02, ge_p_gb=0.01)
        assert lossy.faults.up_loss == 0.02 and lossy.faults.ge_on
        stacked = mod.tor_failure(
            mod.uplink_failure(lossy, uplink=3, start=0, end=50),
            rack=2, start=10, end=90)
        assert stacked.faults.up_loss == 0.02
        assert stacked.faults.link_fail == ((3, 0, 50),)
        assert stacked.faults.tor_fail == ((2, 10, 90),)
        with pytest.raises(ValueError, match="enabled fabric"):
            mod.lossy_fabric(type(f)(None), up_loss=0.1)
    port = scenarios.tor_failure(scenarios.uplink_failure(
        fab.with_lossy(down_loss=0.1, seed=4), uplink=1, start=5, end=9),
        rack=0, start=1, end=2)
    jax_ = jscen.tor_failure(jscen.uplink_failure(
        jfab.with_lossy(down_loss=0.1, seed=4), uplink=1, start=5, end=9),
        rack=0, start=1, end=2)
    assert isinstance(port.faults, FaultConfig)
    assert dataclasses.asdict(port.faults) == dataclasses.asdict(jax_.faults)
    assert port.with_uplink_failure(uplink=0, start=0, end=1).faults \
        .link_fail == ((1, 5, 9), (0, 0, 1))
