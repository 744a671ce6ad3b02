"""The port's sweep engine against the JAX package's, on the CPU.

Runs are batched on the step's run axis, so every check here is that
batching changes nothing: port ``run_sweep`` == JAX ``run_sweep`` ==
the port's own sequential ``simulate`` (exact sweeps, two static-shape
groups), chunked == flat, and streaming histograms and integer counters
equal to JAX's. ``q_mean_bytes`` agrees within ``rtol=1e-6``: the JAX
package sums the per-host float32 ``q_sum`` in float32, whose rounding
depends on the reduction order, while the port sums the same
integer-valued float32 entries in float64, which is exact; over 8 hosts
float32 rounding stays within a few ulp (1.2e-7 each).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SimConfig as JConfig
from repro.core import SweepSpec as JSweepSpec
from repro.core import StreamSpec as JStreamSpec
from repro.core import make_messages as jmake
from repro.core import run_sweep as jrun_sweep
from repro.core import sweep as jsweep
from repro_torch.core import (FabricConfig, SimConfig, StreamSpec,
                              SweepSpec, SweepStats, WorkloadSpec,
                              make_messages, run_sweep, simulate)
from repro_torch.core import sweep as sweep_mod
from repro_torch.kernels.arbiter import kernel

torch.set_num_threads(1)
BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "sweep_speed.json"
SMALL = dict(n_hosts=4, max_slots=450, ring_cap=128)


def _tables(make, lengths=(40, 40, 55), seed0=0, n_hosts=4):
    return [make("W2", n_hosts=n_hosts, load=0.6, n_messages=n,
                 slot_bytes=256, seed=seed0 + s)
            for s, n in enumerate(lengths)]


def _assert_same_result(a, b, msg=""):
    np.testing.assert_array_equal(a.completion, b.completion, err_msg=msg)
    np.testing.assert_array_equal(a.q_max_bytes, b.q_max_bytes, err_msg=msg)
    np.testing.assert_array_equal(a.prio_drained_bytes,
                                  b.prio_drained_bytes, err_msg=msg)
    np.testing.assert_array_equal(a.busy_frac, b.busy_frac, err_msg=msg)
    np.testing.assert_array_equal(a.wasted_frac, b.wasted_frac, err_msg=msg)
    np.testing.assert_array_equal(a.q_mean_bytes, b.q_mean_bytes,
                                  err_msg=msg)
    assert a.lost_chunks == b.lost_chunks, msg
    assert a.n_complete == b.n_complete, msg


# ------------------------------------------------------------ validation --

def test_streamspec_validation():
    with pytest.raises(ValueError, match="n_buckets"):
        StreamSpec(n_buckets=1)
    with pytest.raises(ValueError, match="max_slowdown"):
        StreamSpec(max_slowdown=1.0)
    with pytest.raises(ValueError, match="small_bytes"):
        StreamSpec(small_bytes=999)          # not a size-bucket edge
    with pytest.raises(ValueError, match="increasing"):
        StreamSpec(size_edges=(1000, 256))
    with pytest.raises(ValueError, match="warmup_frac"):
        StreamSpec(warmup_frac=1.0)
    s = StreamSpec()
    assert s.rel_err_bound < 0.01            # defaults: ~0.9%
    assert s.rel_err_bound == JStreamSpec().rel_err_bound
    assert hash(s)


def test_sweepspec_validation():
    with pytest.raises(ValueError, match="needs `tables`"):
        SweepSpec(seeds=(0,), workload="W1")
    with pytest.raises(ValueError, match="load is part"):
        SweepSpec(seeds=(0,), workload=WorkloadSpec(workload="W1",
                                                    load=0.5), load=0.5)
    with pytest.raises(ValueError, match="chunk_slots"):
        SweepSpec(seeds=(0,), workload="W1", load=0.5, chunk_slots=0)
    with pytest.raises(ValueError, match="return_state"):
        SweepSpec(seeds=(0,), workload="W1", load=0.5, streaming=True,
                  return_state=True)
    assert SweepSpec(seeds=(0,), workload="W1", load=0.5,
                     streaming=True).stream == StreamSpec()
    with pytest.raises(TypeError, match="SweepSpec"):
        run_sweep(SimConfig(device="cpu"), {"seeds": (0,)})


def test_shard_knob_validation():
    assert sweep_mod.resolve_devices(False) == 1
    assert sweep_mod.resolve_devices(1) == 1
    assert sweep_mod.resolve_devices(True) == 1     # the CPU is one device
    with pytest.raises(ValueError, match="devices"):
        sweep_mod.resolve_devices(10_000)


def test_group_runs_preserves_order():
    keys = [(100, 4), (80, 4), (100, 4), (80, 2)]
    groups = sweep_mod.group_runs(keys)
    assert groups == {(100, 4): [0, 2], (80, 4): [1], (80, 2): [3]}
    assert groups == jsweep.group_runs(keys)


# ------------------------------------------------- host-side functions ---

def test_streaming_functions_equal_jax():
    rng = np.random.default_rng(0)
    for stream in (StreamSpec(), StreamSpec(n_buckets=64,
                                            max_slowdown=100.0)):
        jstream = JStreamSpec(n_buckets=stream.n_buckets,
                              max_slowdown=stream.max_slowdown)
        np.testing.assert_array_equal(sweep_mod.sd_bucket_edges(stream),
                                      jsweep.sd_bucket_edges(jstream))
        b = np.arange(stream.n_buckets)
        np.testing.assert_array_equal(sweep_mod.bucket_mid(stream, b),
                                      jsweep.bucket_mid(jstream, b))
        for n in (1, 7, 400):
            sd = 1.0 + rng.lognormal(0.0, 1.0, n)
            sd[rng.random(n) < 0.3] = 1.0
            sd[rng.random(n) < 0.05] = 1e9           # past max_slowdown
            h = sweep_mod.streaming_hist(sd, stream)
            np.testing.assert_array_equal(h, jsweep.streaming_hist(sd,
                                                                   jstream))
            for q in (0.0, 10.0, 50.0, 99.0, 100.0):
                assert sweep_mod.percentile_from_hist(h, stream, q) \
                    == jsweep.percentile_from_hist(h, jstream, q)
                assert sweep_mod.streaming_percentile(sd, q, stream) \
                    == jsweep.streaming_percentile(sd, q, jstream)
        assert sweep_mod.percentile_from_hist(
            np.zeros(stream.n_buckets, np.int64), stream, 99) is None


# ---------------------------------------------------------- exact sweeps --

@pytest.mark.parametrize("proto,backend", [("homa", "reference"),
                                           ("pias", "fused"),
                                           ("phost", "fused")])
def test_exact_sweep_equals_jax_and_sequential(proto, backend):
    """Two groups (table lengths 40 and 55); the batched port equals the
    JAX sweep and the port's own one-run-at-a-time simulate."""
    cfg = SimConfig(protocol=proto, backend=backend, device="cpu", **SMALL)
    tables = _tables(make_messages)
    got = run_sweep(cfg, SweepSpec(tables=tables, shared_alloc=True))
    want = jrun_sweep(JConfig(protocol=proto, **SMALL),
                      JSweepSpec(tables=_tables(jmake), shared_alloc=True))
    alloc = got[0].alloc
    assert all(r.alloc == alloc for r in got)
    for i, (g, w, t) in enumerate(zip(got, want, tables)):
        _assert_same_result(g, w, f"{proto} run {i} vs JAX")
        _assert_same_result(g, simulate(cfg, t, alloc=alloc),
                            f"{proto} run {i} vs sequential")
    assert sum(r.n_complete for r in got) > 0


def test_sweep_from_seeds_and_return_state():
    """The seeds form builds the same tables as make_messages, and
    ``return_state`` gives each run its own slice of the batch."""
    cfg = SimConfig(protocol="homa", device="cpu", **SMALL)
    spec = SweepSpec(seeds=(3, 4), workload=WorkloadSpec(
        workload="W1", load=0.7, n_messages=50), return_state=True)
    res = run_sweep(cfg, spec)
    for r, s in zip(res, (3, 4)):
        t = make_messages("W1", n_hosts=4, load=0.7, n_messages=50,
                          slot_bytes=256, seed=s)
        ref = simulate(cfg, t, return_state=True)
        _assert_same_result(r, ref)
        for k, v in ref.state.items():
            np.testing.assert_array_equal(r.state[k], v, err_msg=k)


@pytest.mark.parametrize("proto", ["homa", "ndp"])
def test_chunked_equals_flat(proto):
    """chunk_slots steps the same slots in pieces, including a remainder
    chunk (450 % 200 != 0) and a chunk past the horizon."""
    cfg = SimConfig(protocol=proto, device="cpu",
                    fabric=FabricConfig(racks=2, up_cap=32), **SMALL)
    tables = _tables(make_messages, lengths=(40, 40))
    base = run_sweep(cfg, SweepSpec(tables=tables))
    for chunk in (200, 5000):
        got = run_sweep(cfg, SweepSpec(tables=tables, chunk_slots=chunk))
        for a, b in zip(base, got):
            _assert_same_result(a, b, f"chunk {chunk}")
            np.testing.assert_array_equal(a.tor_up_q_max_bytes,
                                          b.tor_up_q_max_bytes)


# ------------------------------------------------------------- streaming --

@pytest.mark.parametrize("proto,fabric,backend", [
    ("homa", False, "fused"), ("basic", True, "reference")])
def test_streaming_equals_jax(proto, fabric, backend):
    from repro.core import FabricConfig as JFabric
    fab = dict(racks=2, up_cap=32) if fabric else None
    stream = StreamSpec(warmup_frac=0.2)
    jstream = JStreamSpec(warmup_frac=0.2)
    cfg = SimConfig(protocol=proto, backend=backend, device="cpu",
                    fabric=FabricConfig(**fab) if fab else None, **SMALL)
    got = run_sweep(cfg, SweepSpec(tables=_tables(make_messages),
                                   shared_alloc=True, chunk_slots=128,
                                   streaming=stream))
    want = jrun_sweep(
        JConfig(protocol=proto, fabric=JFabric(**fab) if fab else None,
                **SMALL),
        JSweepSpec(tables=_tables(jmake), shared_alloc=True,
                   chunk_slots=128, streaming=jstream))
    for g, w in zip(got, want):
        assert isinstance(g, SweepStats)
        np.testing.assert_array_equal(g.hist, w.hist)
        for f in ("n_complete", "n_messages", "busy_frac", "wasted_frac",
                  "uplink_busy_frac", "q_max_bytes", "lost_chunks",
                  "tor_up_busy_frac"):
            assert getattr(g, f) == getattr(w, f), f
        np.testing.assert_array_equal(g.prio_drained_bytes,
                                      w.prio_drained_bytes)
        np.testing.assert_allclose(g.q_mean_bytes, w.q_mean_bytes,
                                   rtol=1e-6)
        assert g.summary()["p99_all"] == w.summary()["p99_all"]
        assert g.percentile_small(99.0) == w.percentile_small(99.0)
    assert sum(g.n_counted for g in got) > 0


def test_streaming_hist_equals_exact_run():
    """The device histogram of a streaming sweep is the host mirror of the
    exact run's slowdowns."""
    cfg = SimConfig(protocol="homa", device="cpu", **SMALL)
    tables = _tables(make_messages, lengths=(55,))
    exact = run_sweep(cfg, SweepSpec(tables=tables))[0]
    stt = run_sweep(cfg, SweepSpec(tables=tables, streaming=True))[0]
    assert stt.n_complete == exact.n_complete
    np.testing.assert_array_equal(
        stt.hist.sum(axis=0),
        sweep_mod.streaming_hist(exact.slowdown[exact.done], stt.stream))


# ------------------------------------------------------ baseline replay --

def test_mega_cell_p99_homa_replays_the_baseline():
    """``benchmarks/baselines/sweep_speed.json``'s mega cell for homa: 3
    loads x 4 seeds of W1 at 8 hosts in one batch of 12, chunked and
    streaming, on the fused backend — the pooled p99 and completions
    match the committed baseline."""
    mega = next(r for r in json.loads(BASELINE.read_text())
                if r["kind"] == "mega")
    tables = [make_messages(mega["workload"], n_hosts=8, load=ld,
                            n_messages=mega["n_messages"], slot_bytes=256,
                            seed=s)
              for ld in (0.5, 0.7, 0.9) for s in range(mega["n_seeds"])]
    horizon = max(int(t.arrival_slot.max()) for t in tables) + 600
    cfg = SimConfig(n_hosts=8, protocol="homa", ring_cap=256,
                    max_slots=horizon, backend="fused", device="cpu")
    kernel.reset_launch_counts()
    stats = run_sweep(cfg, SweepSpec(tables=tables, shared_alloc=True,
                                     shard=True, chunk_slots=512,
                                     streaming=True))
    assert set(kernel.launch_counts().values()) == {0}     # CPU: plain
    pooled = sum(s.hist.sum(axis=0) for s in stats)
    p99 = sweep_mod.percentile_from_hist(pooled, stats[0].stream, 99.0)
    assert round(p99, 4) == mega["p99_homa"]
    # the baseline completed every message of all 72 runs; so does homa
    assert mega["completions"] == mega["n_runs"] * mega["n_messages"]
    assert sum(s.n_complete for s in stats) == len(tables) \
        * mega["n_messages"]
