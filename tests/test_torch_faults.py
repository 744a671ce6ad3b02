"""The port's fault layer (``core/faults.py``) against the JAX package's, on
the CPU.

  - C1: the uint32 hash and the float32 uniforms, bit for bit, on random
    and edge inputs (0, 2**31 - 1, large epochs, an input whose hash is
    0xFFFFFFFF, float32 rounding ties), and a loss threshold whose
    float32 and float64 roundings fall on either side of a draw.
  - Failure-window masks over window edges; ``select_uplink`` under tied
    occupancies and masked uplinks, and flowlet hashing across epochs.
  - ``apply_recovery`` under both timers, and ``FaultConfig``'s errors.
  - Runs: the port's ``simulate`` equals JAX's, state key by key, for
    every protocol under loss and for every routing policy under failure
    windows; ``backend="fused"`` equals JAX's ``pallas_fused`` (interpret
    mode); plans cut at any slot change nothing; sweeps equal
    sequential runs; and the ``faults_smoke`` benchmark point reproduces
    ``benchmarks/baselines/faults_smoke.json`` exactly.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import FaultConfig as JFault
from repro.core import SimConfig as JConfig
from repro.core import make_messages as jmake
from repro.core import simulate as jsimulate
from repro.core import faults as jfaults
from repro.core.protocols import get_protocol as jget_protocol
from repro_torch.core import (FabricConfig, FaultConfig, SimConfig,
                              SweepSpec, make_messages, run_sweep,
                              simulate)
from repro_torch.core import faults
from repro_torch.core.protocols import get_protocol
from repro_torch.core.sim import (_init_state, prepare, run_slots,
                                  stack_static, step_fn)

torch.set_num_threads(1)
ALL_PROTOS = ["homa", "basic", "phost", "pias", "pfabric", "ndp"]
SALTS = [faults._SALT_CHUNK, faults._SALT_GE, faults._SALT_FWD,
         faults._SALT_FLOWLET]
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "faults_smoke.json"


def _row(cfg, M, t):
    """Slot ``t``'s row of a one-slot plan."""
    return faults.plan_row(cfg, faults.slot_plan(cfg, M, t, t + 1), t, t)


def _conserved(st) -> bool:
    """Loss-aware chunk conservation (``tests/test_faults.py``): every
    transmission is delivered, buffered in a tier, or counted lost."""
    return (int(st["sent"].sum()) + int(st["retx"].sum())
            == int(st["recv"].sum()) + int(st["r_valid"].sum())
            + int(st["u_valid"].sum()) + int(st["lost"])
            + int(st["u_lost"]) + int(st["f_lost"]))


# ------------------------------------------------------------------ C1 ----

def _port_hash(a, b, seed, salt):
    return faults._hash_u32(torch.as_tensor(np.asarray(a, np.int64)),
                            torch.as_tensor(np.asarray(b, np.int64)),
                            seed, salt).numpy()


def _jax_hash(a, b, seed, salt):
    return np.asarray(jfaults._hash_u32(
        jnp.asarray(np.asarray(a, np.int64).astype(np.uint32)),
        jnp.asarray(np.asarray(b, np.int64).astype(np.uint32)),
        seed, salt)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 9, 2 ** 31 - 1, -5])
@pytest.mark.parametrize("salt", SALTS)
def test_hash_and_uniforms_match_jax_bit_for_bit(seed, salt):
    rng = np.random.default_rng(seed & 0xFFFF)
    a = np.concatenate([rng.integers(0, 2 ** 31, 500),
                        [0, 1, 143, 7999, 2 ** 31 - 1]])
    b = np.concatenate([rng.integers(0, 2 ** 31, 500),
                        [0, 2 ** 31 - 1, 2 ** 21 - 1, 2 ** 30, 12345]])
    got = _port_hash(a, b, seed, salt)
    want = _jax_hash(a, b, seed, salt)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2 ** 32
    u = faults._uniform01(torch.as_tensor(a), torch.as_tensor(b), seed,
                          salt).numpy()
    ju = np.asarray(jfaults._uniform01(jnp.asarray(a.astype(np.int32)),
                                       jnp.asarray(b.astype(np.int32)),
                                       seed, salt))
    assert u.dtype == ju.dtype == np.float32
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    # broadcasting (rows x slots), as the slot plans use it
    tab = faults._uniform01(torch.arange(16, dtype=torch.int32),
                            torch.arange(0, 4000, 97,
                                         dtype=torch.int32)[:, None],
                            seed, salt).numpy()
    jtab = np.asarray(jfaults._uniform01(
        jnp.arange(16, dtype=jnp.int32),
        jnp.arange(0, 4000, 97, dtype=jnp.int32)[:, None], seed, salt))
    np.testing.assert_array_equal(tab.view(np.int32), jtab.view(np.int32))


def test_negative_int32_inputs_wrap_like_jax():
    a = np.array([-1, -2 ** 31, -7], np.int64)
    b = np.array([3, -1, 2 ** 31 - 1], np.int64)
    for salt in SALTS:
        np.testing.assert_array_equal(_port_hash(a, b, 3, salt),
                                      _jax_hash(a, b, 3, salt))


def _unxorshift(h, s):
    x = h
    for _ in range(32 // s + 1):
        x = h ^ (x >> s)
    return x


def _preimage_of(h, seed, salt):
    """The ``a`` whose hash with ``b = 0`` is ``h`` (the mix is a
    bijection of ``a``)."""
    m = 1 << 32
    y = _unxorshift(h, 16) * pow(0x297A2D39, -1, m) % m
    y = _unxorshift(y, 13) * pow(0x2C1B3C6D, -1, m) % m
    y = _unxorshift(y, 15)
    k = ((seed * 0x27D4EB2F) ^ salt) & 0xFFFFFFFF
    return (y ^ k) * pow(0x9E3779B1, -1, m) % m


@pytest.mark.parametrize("salt", SALTS)
def test_a_hash_of_all_ones_draws_exactly_one(salt):
    a = _preimage_of(0xFFFFFFFF, 1, salt)
    assert int(_jax_hash([a], [0], 1, salt)[0]) == 0xFFFFFFFF
    assert int(_port_hash([a], [0], 1, salt)[0]) == 0xFFFFFFFF
    u = faults._uniform01(torch.tensor([a]), torch.tensor([0]), 1, salt)
    assert u.dtype == torch.float32 and float(u[0]) == 1.0
    ju = jfaults._uniform01(jnp.asarray(np.array([a], np.uint32)),
                            jnp.asarray(np.array([0], np.uint32)), 1, salt)
    assert float(ju[0]) == 1.0


def test_float32_conversion_rounds_as_jax_at_ties():
    # hashes around float32 rounding ties (2**24 and up: a float32 holds
    # 24 bits), the largest values and the round-up to 2**32
    h = np.array([0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 2 ** 24 + 3,
                  0x01000080, 0x01000180, 0x7FFFFFBF, 0x7FFFFFC0,
                  2 ** 31 - 1, 2 ** 31, 0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFFFE,
                  0xFFFFFFFF], np.int64)
    got = faults._unit_f32(torch.as_tensor(h)).numpy()
    want = np.asarray(jnp.asarray(h.astype(np.uint32)).astype(jnp.float32)
                      * jnp.float32(2.0 ** -32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-1] == 1.0 and got[-3] == 1.0 and got[0] == 0.0


def _fwd_setup(p_name, p_val, ge=False):
    """A 2-rack fabric whose only fault is the given probability."""
    kw = {p_name: p_val}
    if ge:
        kw = dict(ge_p_gb=0.5, ge_p_bg=p_val)
    fab = dict(racks=2, oversub=2.0, up_cap=16)
    return (SimConfig(n_hosts=8, fabric=FabricConfig(**fab, faults=kw),
                      device="cpu"),
            JConfig(n_hosts=8, fabric=JFabric(**fab, faults=kw)))


def test_threshold_compares_in_float32_like_jax():
    """A probability whose float32 rounding equals a draw while its
    float64 value lies above it: JAX compares in float32 (the Python
    float is weakly typed), so the draw is not a loss — nor in the
    port. The GE ``>=`` test is the mirror case."""
    U, now = 4, 777
    u = faults._uniform01(torch.arange(U, dtype=torch.int32),
                          torch.tensor(now, dtype=torch.int32), 0,
                          faults._SALT_FWD).numpy()
    k = int(np.argmax(u))
    ulp = float(np.spacing(u[k]))
    p = float(u[k]) + 0.25 * ulp               # float32(p) == u[k]
    assert np.float32(p) == u[k] and float(u[k]) < p
    cfg, jcfg = _fwd_setup("down_loss", p)
    st = faults.init_fault_state(cfg, 10, 1)
    msg = torch.arange(U, dtype=torch.int32)[None]
    dst = torch.full((1, U), 5, dtype=torch.int32)
    any_e = torch.ones((1, U), dtype=torch.bool)
    tnow = torch.tensor(now, dtype=torch.int32)
    ok, _ = faults.forward_losses(cfg, st, msg, dst, any_e, tnow,
                                  _row(cfg, 10, now))
    jok, _ = jfaults.forward_losses(jcfg, jfaults.init_fault_state(jcfg, 10),
                                    jnp.arange(U, dtype=jnp.int32),
                                    jnp.full((U,), 5, jnp.int32),
                                    jnp.ones((U,), bool), now)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    assert bool(ok[0, k])                      # float64 would drop it
    # GE: a bad link stays bad iff u >= ge_p_bg: equal in float32, below
    # in float64
    ug = faults._uniform01(torch.arange(U, dtype=torch.int32),
                           torch.tensor(now, dtype=torch.int32), 0,
                           faults._SALT_GE).numpy()
    k = int(np.argmax(ug))
    p = float(ug[k]) + 0.25 * float(np.spacing(ug[k]))
    cfg, jcfg = _fwd_setup(None, p, ge=True)
    st = {**faults.init_fault_state(cfg, 10, 1),
          "ge_bad": torch.ones((1, U), dtype=torch.bool)}
    got = faults.advance_ge(cfg, st, _row(cfg, 10, now))
    jst = {**jfaults.init_fault_state(jcfg, 10),
           "ge_bad": jnp.ones((U,), bool)}
    want = jfaults.advance_ge(jcfg, jst, now)
    np.testing.assert_array_equal(got["ge_bad"][0].numpy(),
                                  np.asarray(want["ge_bad"]))
    assert bool(got["ge_bad"][0, k])           # float64 would recover


def test_drop_scatters_match_jax_mode_drop():
    """``first_loss.at[cm].min(..., mode="drop")`` and ``msg_lost.at[cm]
    .add(..., mode="drop")`` with the sentinel M where nothing drained:
    the port's spare-element scatters, per run of a batch."""
    from repro_torch.core.scatter import add_drop, amin_drop
    rng = np.random.default_rng(5)
    B, M, n = 3, 10, 12
    a = rng.integers(0, 100, (B, M)).astype(np.int32)
    idx = rng.integers(0, M + 1, (B, n)).astype(np.int32)   # M: sentinel
    vals = rng.integers(0, 120, (B, n)).astype(np.int32)
    keep = rng.random((B, n)) < 0.6
    t = [torch.from_numpy(x) for x in (a, idx, vals, keep)]
    got_min = amin_drop(*t).numpy()
    got_add = add_drop(*t).numpy()
    for b in range(B):
        j = jnp.asarray(a[b])
        jv = jnp.where(keep[b], vals[b], 2 ** 30)
        np.testing.assert_array_equal(
            got_min[b], np.asarray(j.at[idx[b]].min(jv, mode="drop")))
        np.testing.assert_array_equal(
            got_add[b], np.asarray(j.at[idx[b]].add(
                jnp.where(keep[b], vals[b], 0), mode="drop")))


# -------------------------------------------------- masks and routing ----

WINDOWS = dict(link_fail=((1, 100, 200), (6, 0, 1)),
               tor_fail=((2, 150, 250), (0, 199, 201)))


def test_down_masks_follow_schedules_and_match_jax():
    fab = dict(racks=4, oversub=2.0)
    cfg = SimConfig(n_hosts=16, fabric=FabricConfig(**fab, faults=WINDOWS),
                    device="cpu")
    jcfg = JConfig(n_hosts=16, fabric=JFabric(**fab, faults=WINDOWS))
    t = torch.arange(0, 300, dtype=torch.int32)
    link = faults.link_down_mask(cfg, t).numpy()
    host = faults.host_down_mask(cfg, t).numpy()
    assert link.shape == (300, 8) and host.shape == (300, 16)
    for s in range(300):
        np.testing.assert_array_equal(
            link[s], np.asarray(jfaults.link_down_mask(jcfg, s)))
        np.testing.assert_array_equal(
            host[s], np.asarray(jfaults.host_down_mask(jcfg, s)))
    # the JAX package's own example (tests/test_faults.py)
    assert link[150].tolist() == [False, True, False, False, True, True,
                                  False, False]
    assert not link[99][:6].any() and link[0][6] and not link[1][6]
    assert host[160].tolist() == [False] * 8 + [True] * 4 + [False] * 4
    assert host[199][:4].all() and host[200][:4].all() \
        and not host[201][:4].any()
    assert not faults.host_down_mask(cfg, 250).any()
    assert faults.link_down_mask(cfg, 5).shape == (8,)


def _select_case(routing, occ_rows, down=()):
    """A 16-host, 2-rack fabric (4 uplinks a TOR) whose uplink rings hold
    ``occ_rows[u]`` valid entries, with uplinks ``down`` failed at slot
    10; every host has chosen some message."""
    faults_kw = dict(link_fail=tuple((u, 5, 20) for u in down)) \
        if down else None
    fab = dict(racks=2, oversub=1.0, up_cap=8, routing=routing)
    cfg = SimConfig(n_hosts=16, fabric=FabricConfig(
        **fab, faults=faults_kw, flowlet_slots=7), device="cpu")
    jcfg = JConfig(n_hosts=16, fabric=JFabric(**fab, faults=faults_kw,
                                              flowlet_slots=7))
    # 16 hosts / 2 racks at oversub 1: 8 uplinks a TOR
    U = cfg.fabric.n_uplinks_total(16)
    valid = np.zeros((U, 8), bool)
    for u, n in enumerate(occ_rows):
        valid[u, :n] = True
    cm = np.arange(16, dtype=np.int32) * 37 % 100
    src_rack = np.arange(16, dtype=np.int32) // 8
    return cfg, jcfg, valid, cm, src_rack


@pytest.mark.parametrize("occ, down, want_rack0", [
    ([3, 1, 1, 2, 5, 5, 5, 5] + [0] * 8, (), 1),       # tie -> lowest
    ([3, 1, 1, 2, 5, 5, 5, 5] + [0] * 8, (1,), 2),     # masked to BIG
    ([0] * 16, (0, 1, 2), 3),
    ([2] * 8 + [4, 4, 1, 1, 1, 4, 4, 4], (10,), 0),
    ([0] * 8 + [0] * 8, tuple(range(8)), 0),           # all down: first
])
def test_adaptive_routing_ties_and_masks_match_jax(occ, down, want_rack0):
    cfg, jcfg, valid, cm, src_rack = _select_case("adaptive", occ, down)
    st = {"u_valid": torch.from_numpy(valid)[None]}
    got = faults.select_uplink(cfg, st, torch.from_numpy(cm)[None],
                               torch.from_numpy(src_rack),
                               _row(cfg, 100, 10) if cfg.fabric.faults
                               else None)
    want = jfaults.select_uplink(jcfg, {"u_valid": jnp.asarray(valid)}, {},
                                 jnp.asarray(cm), jnp.asarray(src_rack), 10)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int(got[0, 0]) == want_rack0        # rack 0's choice


def test_flowlet_routing_matches_jax_across_epochs():
    cfg, jcfg, valid, cm, src_rack = _select_case("flowlet", [0] * 16)
    M = 100
    plan = faults.slot_plan(cfg, M, 3, 40)
    seen = set()
    for t in range(3, 40):
        got = faults.select_uplink(cfg, {}, torch.from_numpy(cm)[None],
                                   torch.from_numpy(src_rack),
                                   faults.plan_row(cfg, plan, 3, t))
        want = jfaults.select_uplink(jcfg, {}, {}, jnp.asarray(cm),
                                     jnp.asarray(src_rack), t)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        seen.add(tuple(got[0].tolist()))
    assert len(seen) == len(range(3 // 7, 39 // 7 + 1))   # one per epoch


def test_plan_rows_do_not_depend_on_the_block():
    """A slot's row is the same in a long block and in a one-slot plan,
    and its draws and masks are JAX's for that slot."""
    fkw = dict(up_loss=0.1, down_loss=0.1, ge_p_gb=0.1, **WINDOWS)
    fab = dict(racks=4, oversub=2.0, routing="flowlet", flowlet_slots=5)
    cfg = SimConfig(n_hosts=16, fabric=FabricConfig(**fab, faults=fkw),
                    device="cpu")
    jcfg = JConfig(n_hosts=16, fabric=JFabric(**fab, faults=fkw))
    plan = faults.slot_plan(cfg, 30, 97, 260)
    for t in (97, 98, 99, 100, 149, 150, 199, 200, 259):
        row = faults.plan_row(cfg, plan, 97, t)
        ref = _row(cfg, 30, t)
        assert row.keys() == ref.keys() == {
            "u_chunk", "u_ge", "u_fwd", "host_down", "link_down", "flowlet"}
        for k in row:
            assert torch.equal(row[k], ref[k]), (t, k)
        np.testing.assert_array_equal(
            row["u_chunk"].numpy(),
            np.asarray(jfaults._uniform01(jnp.arange(16, dtype=jnp.int32),
                                          t, 0, jfaults._SALT_CHUNK)))


# ------------------------------------------------------------- recovery ----

@pytest.mark.parametrize("proto", ["homa", "basic", "phost"])
def test_apply_recovery_matches_jax_under_both_timers(proto):
    """Random quiet periods straddling both timers (RESEND at 40 slots,
    sender fallback at 90): homa's and pHost's receivers resend-poll,
    basic's only times out."""
    rng = np.random.default_rng(7)
    M, H, now = 64, 8, 500
    fkw = dict(resend_slots=40, sender_timeout_slots=90)
    fab = dict(racks=2, oversub=2.0)
    cfg = SimConfig(n_hosts=H, protocol=proto,
                    fabric=FabricConfig(**fab, faults=fkw), device="cpu")
    jcfg = JConfig(n_hosts=H, protocol=proto,
                   fabric=JFabric(**fab, faults=fkw))
    size = rng.integers(1, 40, M)
    recv = np.minimum(rng.integers(0, 30, M), size)
    sent = np.minimum(recv + rng.integers(0, 6, M), size)
    S = {"size": size, "arrival": rng.integers(300, 520, M),
         "dst": rng.integers(0, H, M)}
    st = {"sent": sent, "recv": recv,
          "completion": np.where(rng.random(M) < 0.2, 400, -1),
          "last_arr": rng.integers(300, 500, M),
          "last_rw": rng.integers(0, 500, M), "retx": rng.integers(0, 5, M),
          "grant_r": sent, "first_loss": np.full(M, 2 ** 30)}
    drained = rng.integers(0, M + 1, H)          # M: nothing drained
    any_e = drained < M
    S = {k: np.asarray(v, np.int32) for k, v in S.items()}
    st = {k: np.asarray(v, np.int32) for k, v in st.items()}
    # the port's state also carries the per-run rewind counters
    counters = {k: torch.zeros(1, dtype=torch.int32)
                for k in faults.REWIND_KEYS}
    got = faults.apply_recovery(
        cfg, get_protocol(proto),
        {**{k: torch.from_numpy(v)[None] for k, v in st.items()},
         **counters},
        {k: torch.from_numpy(v)[None] for k, v in S.items()},
        torch.tensor(now, dtype=torch.int32),
        torch.from_numpy(drained.astype(np.int32))[None],
        torch.from_numpy(any_e)[None])
    want = jfaults.apply_recovery(
        jcfg, jget_protocol(proto),
        {k: jnp.asarray(v) for k, v in st.items()},
        {k: jnp.asarray(v) for k, v in S.items()}, now,
        jnp.asarray(drained.astype(np.int32)), jnp.asarray(any_e))
    for k in ("sent", "retx", "last_arr", "last_rw"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    rewound = int((got["retx"][0].numpy() - st["retx"]).sum())
    assert rewound > 0
    # every rewind counted once, by its trigger; basic never RESENDs
    fired = int((np.asarray(want["last_rw"]) == now).sum())
    assert int(got["rw_resend"]) + int(got["rw_timeout"]) == fired
    assert (int(got["rw_resend"]) == 0) == (proto == "basic")


def test_fault_config_validation_errors_match_jax():
    fab = dict(racks=4, oversub=2.0)
    cases = [
        (dict(faults=dict(up_loss=1.5)), "up_loss"),
        (dict(faults=dict(down_loss=-0.1)), "down_loss"),
        (dict(faults=dict(ge_p_gb=1.5)), "ge_p_gb"),
        (dict(faults=dict(ge_p_gb=0.1, ge_p_bg=0.0)), "ge_p_bg"),
        (dict(faults=dict(link_fail=((99, 0, 100),))), "link_fail"),
        (dict(faults=dict(tor_fail=((0, 100, 100),))), "tor_fail"),
        (dict(faults=dict(tor_fail=((4, 0, 1),))), "tor_fail"),
        (dict(faults=dict(resend_slots=0)), "timeouts"),
        (dict(faults=dict(sender_timeout_slots=0)), "timeouts"),
        (dict(flowlet_slots=0), "flowlet_slots"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            SimConfig(n_hosts=16, fabric=FabricConfig(**fab, **kw),
                      device="cpu")
        with pytest.raises(ValueError, match=match):
            JConfig(n_hosts=16, fabric=JFabric(**fab, **kw))
    with pytest.raises(ValueError, match="routing"):
        SimConfig(n_hosts=16, fabric=FabricConfig(**fab, routing="spray"),
                  device="cpu")
    fab2 = FabricConfig(racks=4, faults=dict(up_loss=0.01,
                                             link_fail=[[0, 10, 20]]))
    assert isinstance(fab2.faults, FaultConfig)
    assert fab2.faults.link_fail == ((0, 10, 20),)
    hash(fab2)
    assert not FaultConfig().any_loss and FaultConfig(up_loss=0.1).any_loss
    assert dataclasses.asdict(FaultConfig()) == dataclasses.asdict(JFault())


# ----------------------------------------------------------------- runs ----

TKW = dict(n_hosts=8, load=0.7, n_messages=100, slot_bytes=256, seed=4)
LOSSY = dict(up_loss=0.03, down_loss=0.02, ge_p_gb=0.01, ge_p_bg=0.1,
             resend_slots=60, sender_timeout_slots=150, seed=2)
FAILS = dict(up_loss=0.01, link_fail=((1, 100, 500),),
             tor_fail=((0, 300, 650),), resend_slots=60,
             sender_timeout_slots=150)


def _pair(proto, fkw, routing="ecmp", backend="reference", slots=900,
          jbackend="reference"):
    fab = dict(racks=2, oversub=2.0, up_cap=128, routing=routing,
               faults=fkw)
    kw = dict(n_hosts=8, protocol=proto, max_slots=slots, ring_cap=256)
    r = simulate(SimConfig(**kw, fabric=FabricConfig(**fab), device="cpu",
                           backend=backend), make_messages("W2", **TKW),
                 return_state=True)
    j = jsimulate(JConfig(**kw, fabric=JFabric(**fab), backend=jbackend),
                  jmake("W2", **TKW), return_state=True)
    return r, j


def _same_state(r, j):
    # the port's state adds the per-run rewind counters
    assert set(r.state) == set(j.state) | set(faults.REWIND_KEYS)
    for k in j.state:
        a, b = np.asarray(j.state[k]), r.state[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    np.testing.assert_array_equal(r.retx_chunks, j.retx_chunks)
    np.testing.assert_array_equal(r.msg_lost_chunks, j.msg_lost_chunks)
    np.testing.assert_array_equal(r.recovery_slots, j.recovery_slots)
    assert r.fault_lost_chunks == j.fault_lost_chunks
    assert r.faults == j.faults


@pytest.mark.parametrize("proto", ALL_PROTOS)
def test_simulate_under_loss_matches_jax(proto):
    r, j = _pair(proto, LOSSY)
    _same_state(r, j)
    assert r.fault_lost_chunks > 0
    assert int(r.retx_chunks.sum()) > 0
    assert _conserved(r.state)


@pytest.mark.parametrize("routing", ["ecmp", "flowlet", "adaptive"])
def test_failure_windows_under_each_routing_match_jax(routing):
    r, j = _pair("homa", FAILS, routing=routing)
    _same_state(r, j)
    assert r.fault_lost_chunks > 0 and _conserved(r.state)
    assert r.fabric["routing"] == routing


@pytest.mark.parametrize("routing", ["flowlet", "adaptive"])
def test_routing_without_faults_matches_jax(routing):
    r, j = _pair("homa", None, routing=routing, slots=600)
    assert set(r.state) == set(j.state)
    for k in j.state:
        assert np.array_equal(np.asarray(j.state[k]), r.state[k]), k
    assert r.retx_chunks is None and r.fault_lost_chunks == 0


@pytest.mark.parametrize("proto, fkw, routing", [
    ("homa", FAILS, "adaptive"),
    ("ndp", LOSSY, "flowlet"),
])
def test_fused_backend_matches_jax_pallas_fused(proto, fkw, routing):
    r, j = _pair(proto, fkw, routing=routing, backend="fused", slots=400,
                 jbackend="pallas_fused")
    _same_state(r, j)


def test_plan_blocks_cut_anywhere_match_jax(monkeypatch):
    """Plan blocks of 7 slots against 5-slot flowlet epochs, and
    ``run_slots`` calls that stop at odd slots, cut the plans at odd
    places; the state equals a one-slot-at-a-time loop and one JAX
    run."""
    monkeypatch.setattr(faults, "PLAN_SLOTS", 7)
    fab = FabricConfig(racks=2, oversub=2.0, up_cap=128, routing="flowlet",
                       flowlet_slots=5, faults=dict(LOSSY, **FAILS))
    cfg = SimConfig(n_hosts=8, protocol="homa", max_slots=300,
                    ring_cap=256, fabric=fab, device="cpu")
    tbl = make_messages("W2", **TKW)
    proto = get_protocol("homa")
    S1, alloc = prepare(cfg, tbl)
    S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
    st0 = _init_state(cfg, proto, len(tbl.size))
    planned = st0
    for lo, hi in ((0, 13), (13, 151), (151, 300)):
        planned = run_slots(cfg, proto, S, planned, n_sched, lo, hi)
    st = st0
    with torch.inference_mode():
        for t in range(300):
            st = step_fn(cfg, proto, S, n_sched, st,
                         torch.tensor(t, dtype=torch.int32),
                         _row(cfg, len(tbl.size), t))
    j = jsimulate(JConfig(n_hosts=8, protocol="homa", max_slots=300,
                          ring_cap=256, fabric=JFabric(
                              racks=2, oversub=2.0, up_cap=128,
                              routing="flowlet", flowlet_slots=5,
                              faults=dict(LOSSY, **FAILS))),
                  jmake("W2", **TKW), return_state=True)
    for k in j.state:
        assert np.array_equal(planned[k][0].numpy(), np.asarray(j.state[k])), k
        assert torch.equal(planned[k], st[k]), k


def test_fault_sweep_equals_sequential_runs_and_jax():
    """Loss draws are counter-based, so a batched sweep equals sequential
    runs (``tests/test_faults.py::test_faults_compose_with_run_sweep``);
    its streaming statistics carry the same fault totals."""
    fab = FabricConfig(racks=2, oversub=2.0, routing="flowlet",
                       faults=FaultConfig(up_loss=0.02, seed=9))
    cfg = SimConfig(n_hosts=8, protocol="homa", fabric=fab, max_slots=900,
                    ring_cap=256, device="cpu")
    tkw = dict(n_hosts=8, load=0.6, n_messages=80, slot_bytes=256)
    tables = [make_messages("W2", **tkw, seed=s) for s in range(3)]
    seq = [simulate(cfg, t) for t in tables]
    swe = run_sweep(cfg, SweepSpec(tables=tables))
    stream = run_sweep(cfg, SweepSpec(tables=tables, chunk_slots=250,
                                      streaming=True))
    jcfg = JConfig(n_hosts=8, protocol="homa", max_slots=900, ring_cap=256,
                   fabric=JFabric(racks=2, oversub=2.0, routing="flowlet",
                                  faults=JFault(up_loss=0.02, seed=9)))
    for s, (a, b, c) in enumerate(zip(seq, swe, stream)):
        j = jsimulate(jcfg, jmake("W2", **tkw, seed=s))
        for r in (b, j):
            np.testing.assert_array_equal(a.completion, r.completion)
            np.testing.assert_array_equal(a.retx_chunks, r.retx_chunks)
            np.testing.assert_array_equal(a.msg_lost_chunks,
                                          r.msg_lost_chunks)
            assert a.fault_lost_chunks == r.fault_lost_chunks
        assert c.fault_lost_chunks == a.fault_lost_chunks > 0
        assert c.retx_chunks == int(a.retx_chunks.sum())
        assert c.n_complete == a.n_complete


def test_faults_smoke_reproduces_the_baseline():
    """``benchmarks/faults_figs.py`` ``faults_smoke``: homa at 1% uplink
    loss, W2 at load 0.5 on 16 hosts in 4 racks (2:1), 600 messages,
    through ``run_sweep`` with ``max_slots`` 20000 (``benchmarks/common.py``
    caps it there) — every number of the committed baseline."""
    want = json.loads(BASELINE.read_text())[0]
    tbl = make_messages("W2", n_hosts=16, load=0.5, n_messages=600,
                        slot_bytes=256, seed=0)
    cfg = SimConfig(n_hosts=16, slot_bytes=256, protocol="homa",
                    ring_cap=512, max_slots=20_000, device="cpu",
                    fabric=FabricConfig(racks=4, oversub=2.0,
                                        faults=dict(up_loss=0.01)))
    (r,) = run_sweep(cfg, SweepSpec(tables=[tbl], return_state=True))
    s = r.summary(warmup_frac=0.1)
    fl = s["faults"]
    got = dict(protocol="homa", completion=s["completion_rate"],
               lost_chunks=s["lost_chunks"],
               fault_lost=fl["fault_lost_chunks"],
               retx_chunks=fl["retx_chunks"], msgs_lossy=fl["msgs_lossy"],
               recovery_mean=round(fl["recovery_mean_slots"], 1),
               recovery_p99=round(fl["recovery_p99_slots"], 1))
    assert got == want
    assert _conserved(r.state)
