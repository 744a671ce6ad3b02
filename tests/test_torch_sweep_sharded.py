"""The sharded sweep (``SweepSpec.shard``) on ``torch.distributed``
gloo worlds of 2 and 3 ranks on the CPU (``tests/torch_sweep_worker.py``,
one spawn per world size).

- Every protocol, exact and chunked-streaming, on every rank: the full
  result list, bit-identical to the one-process ``run_sweep`` on the
  same tables — with 3 runs over 2 ranks and 4 over 3 (two groups), so
  groups are padded by replicating their last run.
- homa against the JAX package's ``run_sweep`` on the same tables (the
  setup of ``tests/test_sweep.py``'s eight-device test): completions
  and streaming histograms.
- ``shared_alloc`` over all the tables, not a rank's share; a split
  over fewer ranks than the world; a rank that fails makes every rank
  raise; ``shard`` > 1 with no process group raises.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sweep_worker as W
from repro.core import SimConfig as JSimConfig
from repro.core import SweepSpec as JSweepSpec
from repro.core.sim import run_sweep as jrun_sweep
from repro_torch.core import run_sweep
from repro_torch.core.priorities import allocate_priorities

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    """(world size, every rank's results): the world runs while this
    process computes the one-process references it is held to."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_sweep_worker.py"),
         str(tmp), str(n)], env={**os.environ, "PYTHONPATH":
                                 str(REPO / "src")},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        want = {name: run_sweep(W.config(p), dataclasses.replace(
                    W.spec(n, s), shard=False))
                for name, (p, s, _) in W.cases(n).items()}
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(n)]
    return n, ranks, want


def _same(a, b, path="") -> None:
    """Bit-identical results: arrays (NaN where NaN), numbers, dicts and
    dataclasses field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b or (a != a and b != b), path


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["exact", "streaming"])
@pytest.mark.parametrize("protocol", W.PROTOCOLS)
def test_sharded_equals_one_process(world, protocol, streaming):
    n, ranks, want = world
    name = f"{protocol}-{'streaming' if streaming else 'exact'}"
    assert len(want[name]) == len(W.LENGTHS[n])
    for r, got in enumerate(ranks):
        _same(got[name], want[name], f"rank {r} {name}")


def test_split_over_part_of_the_world(world):
    _, ranks, want = world
    for got in ranks:
        _same(got["homa-streaming-part"], want["homa-streaming-part"])


def test_shared_alloc_over_all_tables(world):
    n, ranks, _ = world
    tables = W.tables(n)
    cfg = W.config("homa")
    want = allocate_priorities(np.concatenate([t.size for t in tables]),
                               unsched_limit=cfg.rtt_bytes,
                               n_prios=cfg.n_prios)
    for got in ranks:
        for stats in got["homa-streaming"]:
            _same(stats.alloc, want)


def test_a_failed_rank_raises_on_every_rank(world):
    n, ranks, _ = world
    for r, got in enumerate(ranks):
        assert got["failure"] is not None, f"rank {r} returned a result"
        assert "rank(s) {1:" in got["failure"] \
            and "injected failure" in got["failure"], got["failure"]


def test_homa_equals_jax(world):
    n, ranks, _ = world
    cfg = JSimConfig(n_hosts=4, max_slots=W.MAX_SLOTS, ring_cap=256,
                     protocol="homa")
    tables = W.tables(n)
    exact = jrun_sweep(cfg, JSweepSpec(tables=tables))
    streaming = jrun_sweep(cfg, JSweepSpec(
        tables=tables, shared_alloc=True, chunk_slots=120, streaming=True))
    for got in ranks:
        for a, b in zip(got["homa-exact"], exact):
            np.testing.assert_array_equal(a.completion, b.completion)
        for a, b in zip(got["homa-streaming"], streaming):
            np.testing.assert_array_equal(a.hist, b.hist)
            assert a.n_complete == b.n_complete


def test_shard_without_a_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="devices"):
        run_sweep(W.config("homa"), W.spec(2, False, shard=2))
