"""The port's simulator against the JAX package's ``simulate``, on the CPU.

Three small random configurations (one single-switch, two leaf-spine,
with rings small enough to drop chunks) must match on every integer field
``tests/test_backend.py::_assert_matches`` checks. Then the carry-across
test: JAX state after ``t`` slots, handed to the port through
``repro_torch.convert.from_jax`` (which gives it the port's run axis),
stepped ``n`` slots by the port, must equal JAX's own state after
``t + n`` slots key by key.
"""
import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import SimConfig as JConfig
from repro.core import make_messages as jmake
from repro.core import simulate as jsimulate
from repro_torch.convert import from_jax
from repro_torch.core import FabricConfig, SimConfig, make_messages, simulate
from repro_torch.core.protocols import get_protocol
from repro_torch.core.sim import prepare, run_slots

ALL_PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]

torch.set_num_threads(1)


def _random_config(i: int, fabric: bool) -> dict:
    """A small configuration drawn from a fixed seed."""
    rng = np.random.default_rng(1006 + i)
    n_hosts = int(rng.choice([4, 6, 8, 12]))
    racks = int(rng.choice([r for r in (2, 3, 4) if n_hosts % r == 0]))
    return dict(
        proto=ALL_PROTOS[int(rng.integers(len(ALL_PROTOS)))],
        workload=str(rng.choice(["W1", "W2", "W3", "W4"])),
        load=float(rng.uniform(0.5, 0.95)), seed=int(rng.integers(100)),
        n_messages=int(rng.integers(60, 150)), n_hosts=n_hosts,
        ring_cap=int(rng.choice([16, 32, 64])),
        max_slots=int(rng.integers(600, 1200)),
        fabric=dict(racks=racks, oversub=float(rng.choice([1.0, 2.0, 3.0])),
                    up_cap=int(rng.choice([8, 16, 64])),
                    seed=int(rng.integers(10))) if fabric else None)


def _configs(c: dict, **over):
    c = {**c, **over}
    kw = dict(protocol=c["proto"], n_hosts=c["n_hosts"],
              max_slots=c["max_slots"], ring_cap=c["ring_cap"])
    jf = JFabric(**c["fabric"]) if c["fabric"] else None
    tf = FabricConfig(**c["fabric"]) if c["fabric"] else None
    tkw = dict(n_hosts=c["n_hosts"], load=c["load"],
               n_messages=c["n_messages"], slot_bytes=256, seed=c["seed"])
    return (JConfig(**kw, fabric=jf, backend="reference"),
            jmake(c["workload"], **tkw),
            SimConfig(**kw, fabric=tf, device="cpu"),
            make_messages(c["workload"], **tkw))


@pytest.mark.parametrize("i,fabric", [(0, False), (1, True), (2, True)])
def test_random_config_matches_jax(i, fabric):
    c = _random_config(i, fabric)
    jcfg, jtbl, tcfg, ttbl = _configs(c)
    a, b = jsimulate(jcfg, jtbl), simulate(tcfg, ttbl)
    msg = f"config {c}"
    np.testing.assert_array_equal(b.completion, a.completion, err_msg=msg)
    assert b.lost_chunks == a.lost_chunks, msg
    np.testing.assert_array_equal(b.q_max_bytes, a.q_max_bytes, err_msg=msg)
    np.testing.assert_array_equal(b.prio_drained_bytes,
                                  a.prio_drained_bytes, err_msg=msg)
    np.testing.assert_array_equal(b.busy_frac, a.busy_frac, err_msg=msg)
    np.testing.assert_array_equal(b.wasted_frac, a.wasted_frac, err_msg=msg)
    if fabric:
        np.testing.assert_array_equal(b.tor_up_q_max_bytes,
                                      a.tor_up_q_max_bytes, err_msg=msg)
        assert b.tor_up_lost_chunks == a.tor_up_lost_chunks, msg
    assert b.n_complete > 0, msg


CARRY = [
    # (protocol, fabric): pias exercises the last-writer scatter, ndp the
    # stamp on slots without a drain, phost the timeout state
    ("homa", True), ("pias", False), ("ndp", False), ("phost", True),
]


@pytest.mark.parametrize("proto,fabric", CARRY)
def test_carry_across_from_jax_state(proto, fabric):
    t, n = 250, 150
    c = dict(proto=proto, workload="W2", load=0.8, seed=3, n_messages=120,
             n_hosts=8, ring_cap=32, max_slots=t,
             fabric=dict(racks=4, oversub=2.0, up_cap=16) if fabric
             else None)
    jcfg, jtbl, tcfg, ttbl = _configs(c)
    mid = jsimulate(jcfg, jtbl, return_state=True)
    end = jsimulate(_configs(c, max_slots=t + n)[0], jtbl,
                    return_state=True)

    S_port, alloc = prepare(tcfg, ttbl)
    assert set(S_port) == set(mid.static)
    for k, v in mid.static.items():          # the port's prepare agrees
        np.testing.assert_array_equal(S_port[k].numpy(), v, err_msg=k)

    # the port's step carries a leading run axis: one run here
    S, st = from_jax(mid.static, mid.state, "cpu")
    for k, v in mid.state.items():
        assert st[k].numpy().dtype == v.dtype, k
        assert st[k].shape == (1,) + v.shape, k
    pr = get_protocol(proto)
    st = run_slots(tcfg, pr, S, st, pr.n_sched(tcfg, alloc), t, t + n)
    assert set(st) == set(end.state)
    for k, v in end.state.items():
        got = st[k][0].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=f"{proto}: {k}")
