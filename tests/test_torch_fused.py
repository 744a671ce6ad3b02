"""The port's fused per-slot arbitration against the JAX package's, on the
CPU.

Three layers:

  1. ``fused_slot_ref`` (the plain version of the CUDA
     ``fused_slot_kernel``) against the JAX fused Pallas kernel in
     interpret mode: single slots through the JAX ``dispatch.fused_slot``
     (normalized answers), batches through ``fused.fused_slot_batch`` on
     ``dispatch.pad_tiles``-padded inputs (raw answers), over the edge
     matrix of ``tests/test_fused.py``. Exact.
  2. ``backend="fused"`` at simulation level against ``"reference"`` and
     against JAX ``simulate(backend="pallas_fused")``, including configs
     whose zero delays leave a stage un-fused. Exact.
  3. Both goldens on ``"fused"`` for homa and pias. Exact.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FabricConfig as JFabric
from repro.core import SimConfig as JConfig
from repro.core import make_messages as jmake
from repro.core import simulate as jsimulate
from repro.kernels.arbiter import dispatch as jdispatch
from repro.kernels.arbiter import fused as jfused
from repro.kernels.arbiter.kernel import BIG as JBIG, NEG as JNEG
from repro_torch.core import FabricConfig, SimConfig, make_messages, simulate
from repro_torch.kernels.arbiter import dispatch, kernel
from repro_torch.kernels.arbiter.ref import BIG, NEG, fused_slot_ref

torch.set_num_threads(1)
GOLDEN = Path(__file__).parent / "golden"


def _drain_problem(rng, H, cap, frac=0.3, B=None):
    lead = () if B is None else (B,)
    prio = rng.integers(0, 8, lead + (H, cap)).astype(np.int32)
    seq = rng.integers(0, 4096, lead + (H, cap)).astype(np.int32)
    elig = rng.random(lead + (H, cap)) < frac
    return prio, seq, elig


def _keys(rng, H, M, frac=0.5, B=None):
    lead = () if B is None else (B,)
    k = rng.integers(1, 1 << 20, lead + (H, M)).astype(np.int32)
    return np.where(rng.random(lead + (H, M)) < frac, k, 0).astype(np.int32)


def _t(stage):
    return None if stage is None else tuple(torch.from_numpy(a)
                                            for a in stage)


# ------------------------------------------------- single slot (dispatch) --

def _single_cases():
    rng = np.random.default_rng(1)
    yield "all stages random", (_drain_problem(rng, 16, 256),
                                _drain_problem(rng, 8, 64),
                                (_keys(rng, 16, 300), 4))
    rng = np.random.default_rng(2)
    p, s, _ = _drain_problem(rng, 8, 128)
    none = np.zeros_like(p, bool)
    yield "all ineligible", ((p, s, none), (p, s, none),
                             (np.zeros((8, 64), np.int32), 3))
    rng = np.random.default_rng(3)
    yield "single-host racks", (_drain_problem(rng, 8, 256),
                                _drain_problem(rng, 8, 32, frac=0.15), None)
    for cap in (1, 37, 100, 129):
        rng = np.random.default_rng(cap)
        yield f"cap {cap}", (_drain_problem(rng, 5, cap), None, None)
    rng = np.random.default_rng(5)
    yield "K above eligible and M", (None, None,
                                     (_keys(rng, 4, 6, frac=0.4), 9))
    yield "empty grant set", (None, None, (np.zeros((8, 128), np.int32), 4))


SINGLE = list(_single_cases())


@pytest.mark.parametrize("name,case", SINGLE, ids=[n for n, _ in SINGLE])
def test_plain_fused_matches_jax_fused_kernel(name, case):
    down, up, topk = case
    want = jdispatch.fused_slot(
        down=None if down is None else tuple(jnp.asarray(a) for a in down),
        up=None if up is None else tuple(jnp.asarray(a) for a in up),
        topk=None if topk is None else (jnp.asarray(topk[0]), topk[1]),
        interpret=True)
    # the port's operands carry a run axis: one run here
    lead = (lambda st: None if st is None
            else tuple(t[None] for t in _t(st)))
    for backend in ("fused", "reference"):
        got = dispatch.fused_slot(
            down=lead(down), up=lead(up),
            topk=None if topk is None else (torch.from_numpy(topk[0])[None],
                                            topk[1]),
            backend=backend)
        assert set(got) == set(want)
        for stage in want:
            for g, w in zip(got[stage], want[stage]):
                np.testing.assert_array_equal(
                    g[0].numpy(), np.asarray(w),
                    err_msg=f"{name}: {stage} on {backend}")
    with pytest.raises(ValueError, match="no fused kernel"):
        dispatch.fused_slot(down=lead(down), up=lead(up), backend="cuda")


def test_raw_single_slot_sentinels():
    """The raw convention the CUDA kernel shares: (BIG, 0) for an empty
    ring row, (NEG, -1) past a top-K row's width."""
    prio = torch.zeros((2, 4), dtype=torch.int32)
    elig = torch.tensor([[False] * 4, [False, True, False, True]])
    keys = torch.tensor([[5, 0, 5]], dtype=torch.int32)
    bp, bi, vals, idx = kernel.fused_slot(down=(prio, prio, elig),
                                          keys=keys, K=5)
    assert bp.tolist() == [BIG, 0] and bi.tolist() == [0, 1]
    assert vals.tolist() == [[5, 5, 0, NEG, NEG]]
    assert idx.tolist() == [[0, 2, 1, -1, -1]]
    assert (BIG, NEG) == (JBIG, JNEG)


# ------------------------------------------------------- batched (raw) -----

def _pad_batch(arrays, fills, K=None):
    """Pad every element of a batch with the JAX package's shared
    pad-and-tile policy, then restack."""
    out = []
    for b in range(arrays[0].shape[0]):
        elems = [jnp.asarray(a[b]) for a in arrays]
        if K is not None:
            elems = [jdispatch.pad_min_cols(elems[0], K)]
        padded, _ = jdispatch.pad_tiles(tuple(elems), fills)
        out.append(padded)
    return tuple(jnp.stack([o[i] for o in out]) for i in range(len(arrays)))


@pytest.mark.parametrize("B,H,cap,U,ucap,M,K,stages", [
    (5, 8, 128, 4, 64, 64, 3, "down,up,topk"),
    (3, 13, 100, 9, 37, 300, 4, "down,topk"),     # ragged everywhere
    (4, 8, 256, 8, 32, 6, 9, "up,topk"),          # M < K, single-host racks
    (2, 5, 1, 3, 129, 50, 7, "down,up"),
    (6, 16, 64, 4, 16, 200, 1, "topk"),
])
def test_plain_fused_batch_matches_jax_fused_batch(B, H, cap, U, ucap, M, K,
                                                   stages):
    rng = np.random.default_rng(B * 100 + H)
    down = _drain_problem(rng, H, cap, B=B) if "down" in stages else None
    up = _drain_problem(rng, U, ucap, 0.15, B=B) if "up" in stages else None
    keys = _keys(rng, H, M, B=B) if "topk" in stages else None
    if down is not None:
        down[2][:, 0] = False                    # all-ineligible rows
    if keys is not None:
        keys[:, 1] = 0                           # empty grant rows
    want = jfused.fused_slot_batch(
        down=None if down is None else _pad_batch(down, (JBIG, JBIG, False)),
        up=None if up is None else _pad_batch(up, (JBIG, JBIG, False)),
        keys=None if keys is None else _pad_batch((keys,), (JNEG,), K)[0],
        K=K if keys is not None else 0, interpret=True)
    got = kernel.fused_slot_batch(
        down=_t(down), up=_t(up),
        keys=None if keys is None else torch.from_numpy(keys), K=K)
    ref = fused_slot_ref(_t(down), _t(up),
                         None if keys is None else torch.from_numpy(keys), K)
    rows = ([H, H] if down is not None else []) \
        + ([U, U] if up is not None else []) \
        + ([H, H] if keys is not None else [])
    assert len(got) == len(want) == len(rows)
    for g, r, w, n in zip(got, ref, want, rows):
        assert torch.equal(g, r)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :n])


# ------------------------------------------------ simulation level ---------

SIM_CASES = [
    # (protocol, fabric kwargs or None, SimConfig overrides)
    ("homa", None, {}),
    ("pias", None, {}),
    ("homa", dict(racks=4, oversub=2.0, up_cap=64), {}),
    ("ndp", dict(racks=8, oversub=2.0, up_cap=64), {}),
    # zero delays: the down / up stage is not fused and runs staged
    ("homa", None, {"net_delay_slots": 0}),
    ("homa", dict(racks=4, oversub=2.0, up_cap=64, leaf_delay_slots=0), {}),
]


@pytest.mark.parametrize("proto,fab,over", SIM_CASES)
def test_fused_backend_matches_reference_and_jax(proto, fab, over):
    tkw = dict(n_hosts=8, load=0.7, n_messages=50, slot_bytes=256, seed=10)
    kw = dict(protocol=proto, n_hosts=8, max_slots=450, ring_cap=128, **over)
    jr = jsimulate(JConfig(**kw, fabric=JFabric(**fab) if fab else None,
                           backend="pallas_fused"), jmake("W2", **tkw))
    tbl = make_messages("W2", **tkw)
    res = {b: simulate(SimConfig(**kw, fabric=FabricConfig(**fab) if fab
                                 else None, backend=b, device="cpu"), tbl)
           for b in ("reference", "fused")}
    for r in (res["fused"], jr):
        a = res["reference"]
        np.testing.assert_array_equal(r.completion, a.completion)
        np.testing.assert_array_equal(r.q_max_bytes, a.q_max_bytes)
        np.testing.assert_array_equal(r.prio_drained_bytes,
                                      a.prio_drained_bytes)
        np.testing.assert_array_equal(r.busy_frac, a.busy_frac)
        np.testing.assert_array_equal(r.wasted_frac, a.wasted_frac)
        assert r.lost_chunks == a.lost_chunks
        if fab:
            np.testing.assert_array_equal(r.tor_up_q_max_bytes,
                                          a.tor_up_q_max_bytes)
    assert res["fused"].n_complete > 0


def test_fused_backend_launches_nothing_on_the_cpu():
    kernel.reset_launch_counts()
    simulate(SimConfig(n_hosts=4, max_slots=50, backend="fused",
                       device="cpu"),
             make_messages("W1", n_hosts=4, load=0.5, n_messages=20,
                           slot_bytes=256, seed=0))
    assert set(kernel.launch_counts().values()) == {0}


# ------------------------------------------------------------ goldens ------

@pytest.mark.parametrize("name", ["fabric_disabled", "fabric_enabled"])
@pytest.mark.parametrize("proto", ["homa", "pias"])
def test_goldens_on_the_fused_backend(name, proto):
    g = json.loads((GOLDEN / f"{name}.json").read_text())
    meta, want = g["meta"], g["protocols"][proto]
    fab = FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                       up_cap=meta["up_cap"]) \
        if name == "fabric_enabled" else None
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    r = simulate(SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                           max_slots=meta["max_slots"],
                           ring_cap=meta["ring_cap"], fabric=fab,
                           backend="fused", device="cpu"), tbl)
    assert [int(x) for x in r.completion] == want["completion"]
    assert r.lost_chunks == want["lost_chunks"]
    assert [int(x) for x in r.q_max_bytes] == want["q_max_bytes"]
    assert [int(x) for x in r.prio_drained_bytes] \
        == want["prio_drained_bytes"]
    assert [round(float(x), 8) for x in r.busy_frac] == want["busy"]
    if fab is not None:
        assert [int(x) for x in r.tor_up_q_max_bytes] \
            == want["tor_up_q_max_bytes"]
        assert r.tor_up_lost_chunks == want["tor_up_lost_chunks"]
