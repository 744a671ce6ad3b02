"""The port's Homa-SRPT serving loop (``repro_torch.serving``,
``repro_torch.launch.serve``) against the JAX package on the CPU.

The scheduler is numpy and the standard library in both packages, so
every admission, priority, cutoff and slowdown must be identical; the
serving driver's statistics depend only on the scheduler (its
``decode_fn`` answers from ``r.remaining``), so they must be identical
too, whatever the model computes.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.serving import scheduler as jsched
from repro_torch.launch import serve
from repro_torch.serving import scheduler as tsched

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive(mod, cfg_kw, seed, n_ops=400):
    """One seeded sequence of ``submit``/``step`` calls; returns what the
    scheduler showed after every call."""
    rng = np.random.default_rng(seed)
    sched = mod.HomaScheduler(mod.SchedulerConfig(**cfg_kw))
    trace, rid, now = [], 0, 0.0
    for _ in range(n_ops):
        if rng.random() < 0.35:
            size = int(np.exp(rng.uniform(np.log(1), np.log(300))))
            sched.submit(mod.Request(rid=rid, prompt_len=4,
                                     max_new_tokens=size, arrival=now))
            rid += 1
            retired = []
        else:
            flags = rng.random(64) < 0.05

            def decode_fn(batch, flags=flags):
                return [bool(f) for f in flags[:len(batch)]]

            retired = [r.rid for r in sched.step(decode_fn, now)]
            now += 1.0
        trace.append((
            [r.rid for r in sched.active], [r.rid for r in sched.queue],
            list(sched.cutoffs),
            [sched.priority(r) for r in sched.active],
            [r.rid for r in sched.select_batch()], retired))
    return trace, sched


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(batch_size=4, overcommit=2, n_prios=4, unsched_limit=8),
    dict(batch_size=3, srpt=False),
    dict(batch_size=2, overcommit=0, history=16),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_matches_jax(cfg_kw, seed):
    got, ts = _drive(tsched, cfg_kw, seed)
    want, js = _drive(jsched, cfg_kw, seed)
    assert got == want
    assert [r.rid for r in ts.finished] == [r.rid for r in js.finished]
    np.testing.assert_array_equal(ts.slowdowns(), js.slowdowns())
    assert len(ts.finished) > 0


def _stats(out):
    return {k: out[k] for k in ("served", "steps", "mean_slowdown",
                                "p99_slowdown")}


@pytest.mark.parametrize("extra", [[], ["--no-srpt"]])
def test_serve_main_matches_jax(extra):
    argv = ["--arch", "mamba2-130m", "--smoke", "--requests", "16",
            "--batch-size", "4"] + extra
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    assert set(got) == set(want)
    assert _stats(got) == _stats(want)


def test_serve_stats_are_the_committed_ones():
    """``chip_smoke.py`` holds the full-width serve on the card to
    constants computed with the JAX package (``--smoke``; the statistics
    do not depend on the model); both packages must give them here."""
    expected = _chip_smoke().SERVE_EXPECTED
    argv = ["--arch", "mamba2-130m", "--smoke"] + _chip_smoke().SERVE_ARGV
    assert _stats(jserve.main(argv)) == expected
    assert _stats(serve.main(argv + ["--device", "cpu"])) == expected


def test_llama_serve_matches_jax():
    """The Llama smoke serve gives the JAX package's statistics, which are
    the committed ones (``SERVE_EXPECTED``) whatever the model."""
    argv = ["--arch", "llama3.2-3b", "--smoke"] + _chip_smoke().SERVE_ARGV
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    assert _stats(got) == _stats(want) == _chip_smoke().SERVE_EXPECTED


def test_deepseek_serve_matches_jax():
    """The DeepSeek (MLA + MoE) smoke serve gives the JAX package's
    statistics, the committed ones ``chip_smoke.py`` phase 12 holds the
    full-width serve to (``DEEPSEEK_SERVE_ARGV``, 16 requests:
    ``DEEPSEEK_SERVE_EXPECTED``)."""
    smoke = _chip_smoke()
    argv = ["--arch", "deepseek-v2-lite-16b", "--smoke"] \
        + smoke.DEEPSEEK_SERVE_ARGV
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    assert _stats(got) == _stats(want) == smoke.DEEPSEEK_SERVE_EXPECTED


def test_llama_serve_caches_take_the_delta_shape(monkeypatch):
    """As in the JAX driver, the first step's caches are
    ``cache_shapes(cfg, C, 8)`` and every later step attends to the
    previous step's decode deltas, ``(nb, C, 1, KV, hd)``, at position 4:
    the driver replaces its caches with the deltas and does not append
    them. Both packages show the same shapes at every step."""
    import jax
    from repro.models import model as JM
    from repro_torch.models import model as M

    def record(mod, tree_shapes):
        seen = []
        real = mod.forward_decode

        def spy(cfg, params, token, pos, caches, **kw):
            seen.append((pos, tree_shapes(caches)))
            return real(cfg, params, token, pos, caches, **kw)
        monkeypatch.setattr(mod, "forward_decode", spy)
        return seen

    t_seen = record(M, lambda c: {k: tuple(v.shape) for k, v in
                                  c["blocks"]["s0"].items()})
    j_seen = record(JM, lambda c: {k: tuple(v.shape) for k, v in
                                   c["blocks"]["s0"].items()})
    argv = ["--arch", "llama3.2-3b", "--smoke", "--requests", "3",
            "--batch-size", "2"]
    serve.main(argv + ["--device", "cpu"])
    with jax.disable_jit():
        jserve.main(argv)
    assert t_seen == j_seen and len(t_seen) > 2
    first = {"k": (2, 2, 8, 2, 16), "v": (2, 2, 8, 2, 16)}
    later = {"k": (2, 2, 1, 2, 16), "v": (2, 2, 1, 2, 16)}
    assert t_seen[0] == (4, first)
    assert all(s == (4, later) for s in t_seen[1:])


def test_serve_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke", "--requests", "2"])
