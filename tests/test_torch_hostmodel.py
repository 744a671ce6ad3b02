"""The port's host/NIC stage (``repro_torch.core.hostmodel``) against the
JAX package's (``repro.core.hostmodel``), on the CPU.

Key by key over ``return_state`` on the ``reference`` and ``fused``
backends: the ``kernel_stack`` and ``kernel_bypass`` presets and a custom
host whose RX ring backpressures the downlink, on the single switch, a
4-rack fabric and a lossy fabric; the chunked exact sweep and the
streaming sweep with host statistics; the hooks one at a time on random
ring states; config normalization, the result echo, the enforced
interface and a custom model plugged in through the registry.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import SimConfig as JConfig
from repro.core import SweepSpec as JSweepSpec
from repro.core import make_messages as jmake
from repro.core import run_sweep as jrun_sweep
from repro.core import simulate as jsimulate
from repro.core import hostmodel as jhost
from repro_torch.core import (HOST_PRESETS, FabricConfig, HostConfig,
                              HostModel, SimConfig, SweepSpec,
                              get_host_model, host_preset, make_messages,
                              register_host_model, run_sweep, simulate)
from repro_torch.core import hostmodel
from repro_torch.core.faults import REWIND_KEYS
from repro_torch.core.hostmodel import QSCALE, as_host_config

torch.set_num_threads(1)
CUSTOM = dict(tx_cost_slots=0.5, tx_batch=4, tx_batch_cost_slots=2.0,
              tx_queue_cap=4, rx_cost_slots=1.5, rx_queue_cap=8)
FABRIC = dict(racks=4, oversub=2.0, up_cap=128)
LOSSY = dict(racks=2, oversub=2.0, up_cap=128,
             faults=dict(up_loss=0.02, down_loss=0.01, resend_slots=60,
                         sender_timeout_slots=150, seed=3))
SMALL = dict(n_hosts=8, max_slots=700, ring_cap=256)


def _table(mk, n=120, seed=3, load=0.7):
    return mk("W2", n_hosts=8, load=load, n_messages=n, slot_bytes=256,
              seed=seed)


def _pair(host, fab=None, proto="homa", backend="reference", **kw):
    """The same run through both packages; returns (port, JAX) results
    with state."""
    common = dict(SMALL, protocol=proto, host=host, **kw)
    got = simulate(SimConfig(**common, backend=backend, device="cpu",
                             fabric=FabricConfig(**fab) if fab else None),
                   _table(make_messages), return_state=True)
    want = jsimulate(JConfig(**common,
                             fabric=JFabric(**fab) if fab else None),
                     _table(jmake), return_state=True)
    return got, want


def _assert_same_state(got, want, tag=""):
    ws = {k: np.asarray(v) for k, v in want.state.items()}
    # a fault layer adds the port's per-run rewind counters
    assert set(got.state) - set(REWIND_KEYS) == set(ws), tag
    for k, v in ws.items():
        assert got.state[k].dtype == v.dtype, (tag, k)
        np.testing.assert_array_equal(got.state[k], v, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("host,fab,proto", [
    ("kernel_stack", None, "homa"),
    ("kernel_stack", FABRIC, "pias"),
    ("kernel_bypass", None, "phost"),
    (CUSTOM, FABRIC, "homa"),
    ("kernel_stack", LOSSY, "homa"),
], ids=["stack-switch", "stack-fabric", "bypass-switch", "custom-fabric",
        "stack-lossy"])
def test_state_matches_jax_key_by_key(host, fab, proto, backend):
    got, want = _pair(host, fab, proto, backend)
    _assert_same_state(got, want, f"{host} {proto} {backend}")
    assert got.summary()["host"] == want.summary()["host"]
    assert got.state["h_tx_work_q"].sum() > 0
    if host is CUSTOM:
        # the 8-entry RX ring backpressures the downlink
        assert got.state["h_rx_stall"].sum() > 0
    if fab is LOSSY:
        assert got.fault_lost_chunks > 0 and got.retx_chunks.sum() > 0


def test_chunks_are_conserved_through_the_rx_ring():
    """sent == recv + buffered in the network + lost + in the RX ring."""
    got, _ = _pair("kernel_stack", FABRIC)
    st = got.state
    assert int(st["sent"].sum()) == (
        int(st["recv"].sum()) + int(st["r_valid"].sum())
        + int(st["u_valid"].sum()) + int(st["lost"]) + int(st["u_lost"])
        + int((st["h_rx_tail"] - st["h_rx_head"]).sum()))


def _tables(mk):
    return [_table(mk, n=60, seed=s) for s in (1, 2)]


def test_chunked_sweep_with_host_equals_jax():
    cfg = SimConfig(protocol="homa", host="kernel_stack", device="cpu",
                    fabric=FabricConfig(**FABRIC), **SMALL)
    got = run_sweep(cfg, SweepSpec(tables=_tables(make_messages),
                                   shared_alloc=True, chunk_slots=300))
    want = jrun_sweep(JConfig(protocol="homa", host="kernel_stack",
                              fabric=JFabric(**FABRIC), **SMALL),
                      JSweepSpec(tables=_tables(jmake), shared_alloc=True,
                                 chunk_slots=300))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.completion, w.completion)
        for f in ("host_tx_busy_frac", "host_tx_defer_frac",
                  "host_rx_stall_frac", "host_rx_q_mean_chunks",
                  "host_rx_q_max_chunks"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
        assert g.host == w.host == dataclasses.asdict(
            HOST_PRESETS["kernel_stack"])


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_streaming_sweep_carries_host_stats(backend):
    from repro.core import StreamSpec as JStreamSpec
    from repro_torch.core import StreamSpec
    cfg = SimConfig(protocol="homa", host=CUSTOM, backend=backend,
                    device="cpu", **SMALL)
    got = run_sweep(cfg, SweepSpec(tables=_tables(make_messages),
                                   shared_alloc=True, chunk_slots=250,
                                   streaming=StreamSpec()))
    want = jrun_sweep(JConfig(protocol="homa", host=CUSTOM, **SMALL),
                      JSweepSpec(tables=_tables(jmake), shared_alloc=True,
                                 chunk_slots=250, streaming=JStreamSpec()))
    for g, w in zip(got, want):
        gh, wh = g.summary()["host"], w.summary()["host"]
        # h_tx_work sums in float64 here, float32 in the JAX package
        np.testing.assert_allclose(gh.pop("tx_busy_frac"),
                                   wh.pop("tx_busy_frac"), rtol=1e-6)
        assert gh == wh
        assert g.host_rx_stall_frac > 0
        assert g.summary()["trace"] is None
        np.testing.assert_array_equal(g.hist, w.hist)


# ------------------------------------------------------ hooks one by one --

def _hook_cfgs(host):
    return (SimConfig(n_hosts=6, host=host, device="cpu"),
            JConfig(n_hosts=6, host=host))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hooks_match_jax_on_random_states(seed):
    """``host_tx``, ``rx_deliver``, ``rx_room`` and ``rx_accept`` on
    random budgets, batch counters and rings (full, empty and wrapped
    rows), each run of a B = 3 batch against the JAX hook."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    H, M, B, now = 6, 20, 3, 700
    host = dict(CUSTOM, rx_queue_cap=5)
    cfg, jcfg = _hook_cfgs(host)
    cap = 5
    runs = []
    for _ in range(B):
        head = rng.integers(0, 40, H)
        occ = rng.integers(0, cap + 1, H)
        runs.append({
            "h_tx_budget_q": rng.integers(0, 1200, H),
            "h_tx_work_q": rng.integers(0, 10 ** 5, H),
            "h_tx_defer": rng.integers(0, 50, H),
            "h_tx_cnt": rng.integers(0, 4, H),
            "h_rx_msg": rng.integers(0, M, (H, cap)),
            "h_rx_ready_q": rng.integers((now - 3) * QSCALE,
                                         (now + 3) * QSCALE, (H, cap)),
            "h_rx_head": head, "h_rx_tail": head + occ,
            "h_rx_busy_q": rng.integers((now - 5) * QSCALE,
                                        (now + 5) * QSCALE, H),
            "h_rx_stall": np.zeros(H), "h_rx_q_max": rng.integers(0, 5, H),
            "recv": rng.integers(0, 9, M)})
        runs[-1] = {k: np.asarray(v, np.int32) for k, v in runs[-1].items()}
        runs[-1]["h_rx_q_sum"] = rng.integers(0, 99, H).astype(np.float32)
    want_m = rng.random((B, H)) < 0.7
    msg = rng.integers(0, M, (B, H)).astype(np.int32)
    S = {"size": torch.zeros((B, M), dtype=torch.int32)}
    st = {k: torch.from_numpy(np.stack([r[k] for r in runs]))
          for k in runs[0]}
    nowt = torch.tensor(now, dtype=torch.int32)
    hm, jhm = get_host_model("cpu"), jhost.get_host_model("cpu")
    sent, st_tx = hm.host_tx(cfg, st, torch.from_numpy(want_m), nowt)
    st_d = hm.rx_deliver(cfg, st, S, nowt)
    room = hm.rx_room(cfg, st_d)
    ok = torch.from_numpy(want_m) & room
    st_a = hm.rx_accept(cfg, st_d, S, torch.from_numpy(msg), ok, nowt)
    for b in range(B):
        js = {k: jnp.asarray(v) for k, v in runs[b].items()}
        jsent, jst_tx = jhm.host_tx(jcfg, js, jnp.asarray(want_m[b]), now)
        jst_d = jhm.rx_deliver(jcfg, js, {"size": jnp.zeros(M)}, now)
        jroom = jhm.rx_room(jcfg, jst_d)
        jok = jnp.asarray(want_m[b]) & jroom
        jst_a = jhm.rx_accept(jcfg, jst_d, None, jnp.asarray(msg[b]), jok,
                              now)
        np.testing.assert_array_equal(sent[b].numpy(), np.asarray(jsent))
        np.testing.assert_array_equal(room[b].numpy(), np.asarray(jroom))
        for mine, theirs in ((st_tx, jst_tx), (st_d, jst_d), (st_a, jst_a)):
            for k, v in theirs.items():
                np.testing.assert_array_equal(mine[k][b].numpy(),
                                              np.asarray(v), err_msg=k)


# --------------------------------------------- config + interface API ----

def test_host_config_normalization_and_result_echo():
    assert as_host_config(None) is None
    assert as_host_config("kernel_stack") == HOST_PRESETS["kernel_stack"]
    hc = as_host_config({"tx_cost_slots": 1.5, "rx_queue_cap": 32})
    assert hc.tx_cost_q == int(1.5 * QSCALE) and hc.rx_queue_cap == 32
    with pytest.raises(TypeError, match="HostConfig"):
        as_host_config(42)
    with pytest.raises(ValueError, match="preset"):
        SimConfig(host="not-a-preset", device="cpu")
    with pytest.raises(ValueError, match="tx_cost_slots"):
        SimConfig(host={"tx_cost_slots": -1.0}, device="cpu")
    with pytest.raises(ValueError, match="rx_queue_cap"):
        SimConfig(host={"rx_queue_cap": 0}, device="cpu")
    with pytest.raises(ValueError, match="unknown host model"):
        SimConfig(host={"model": "fpga"}, device="cpu")
    assert not SimConfig(host="ideal", device="cpu").host_on
    assert SimConfig(host="kernel_stack", device="cpu").host_tx_on
    assert not SimConfig(host={"rx_cost_slots": 1.0},
                         device="cpu").host_tx_on
    assert SimConfig(host={"rx_cost_slots": 1.0}, device="cpu").host_rx_on
    tbl = make_messages("W2", n_hosts=2, load=0.5, n_messages=5,
                        slot_bytes=256, seed=0)
    r = simulate(SimConfig(protocol="homa", n_hosts=2, max_slots=300,
                           ring_cap=128, host="kernel_bypass",
                           device="cpu"), tbl)
    assert HostConfig(**r.host) == HOST_PRESETS["kernel_bypass"]
    assert json.loads(r.to_json())["host"]["tx_cost_slots"] == 0.25


@pytest.mark.parametrize("cost", [0.0, 0.001, 0.5, 1.0 / 512, 3.0 / 512,
                                  2.7, 4096.0])
def test_fixed_point_matches_jax(cost):
    """Python's round (half to even) at the quantization ties, as the
    JAX package rounds; the burst cap and the structural gates too."""
    for kw in (dict(tx_cost_slots=cost), dict(rx_cost_slots=cost),
               dict(tx_batch_cost_slots=cost, tx_batch=3, tx_queue_cap=2)):
        a, b = HostConfig(**kw), jhost.HostConfig(**kw)
        for p in ("tx_cost_q", "tx_batch_cost_q", "rx_cost_q", "tx_burst_q",
                  "tx_on", "rx_on", "is_ideal"):
            assert getattr(a, p) == getattr(b, p), (kw, p)
    assert HOST_PRESETS.keys() == jhost.HOST_PRESETS.keys()
    for name, hc in HOST_PRESETS.items():
        assert dataclasses.asdict(hc) == dataclasses.asdict(
            jhost.HOST_PRESETS[name])


def test_host_model_interface_is_enforced():
    class Incomplete(HostModel):
        name = "incomplete"

        def init_state(self, cfg, M, B=1):
            return {}

    with pytest.raises(TypeError, match="abstract"):
        Incomplete()
    with pytest.raises(TypeError, match="HostModel instance"):
        register_host_model(object())
    with pytest.raises(ValueError, match="registered"):
        get_host_model("nope")
    assert host_preset("kernel_stack").tx_batch == 8
    with pytest.raises(ValueError, match="preset"):
        host_preset("nope")


def _completion_slot(cfg, tbl):
    return int(simulate(cfg, tbl).completion[0])


def test_custom_host_model_pluggable():
    """A registered model routes the loop through its own hooks: every
    TX chunk charging twice the configured cost roughly doubles the
    transfer time of one long message."""
    cpu = get_host_model("cpu")

    class DoubleCost(type(cpu)):
        name = "double"

        def host_tx(self, cfg, st, want, now):
            hc = cfg.host
            budget = (st["h_tx_budget_q"] + QSCALE).clamp_max(
                2 * hc.tx_burst_q)
            charge = 2 * hc.tx_cost_q
            ok = budget >= charge
            sent = want & ok
            spend = sent.to(torch.int32) * charge
            return sent, {**st, "h_tx_budget_q": budget - spend,
                          "h_tx_work_q": st["h_tx_work_q"] + spend,
                          "h_tx_defer": st["h_tx_defer"]
                          + (want & ~ok).to(torch.int32)}

    register_host_model(DoubleCost())
    try:
        from repro_torch.core.workloads import MessageTable
        tbl = MessageTable(src=np.array([0], np.int32),
                           dst=np.array([1], np.int32),
                           size=np.array([100 * 256]),
                           arrival_slot=np.array([0], np.int32),
                           workload="one", load=0.0, slot_bytes=256)
        kw = dict(protocol="homa", n_hosts=2, max_slots=1500, ring_cap=512,
                  device="cpu")
        single = _completion_slot(
            SimConfig(**kw, host=HostConfig(tx_cost_slots=1.0)), tbl)
        double = _completion_slot(
            SimConfig(**kw, host=HostConfig(model="double",
                                            tx_cost_slots=1.0)), tbl)
        assert 1.7 * single < double < 2.3 * single, (single, double)
    finally:
        del hostmodel._HOST_MODELS["double"]
