"""The port's data pipeline (``repro_torch.data.pipeline``, a copy of the
JAX package's pure-numpy module) against the JAX package's: batches bit
for bit for several (seed, step, host), and the prefetcher's order and
shutdown."""
import threading

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as P


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("vocab", [100, 256, 50280])
@pytest.mark.parametrize("n_hosts, host_id", [(1, 0), (2, 1), (4, 2)])
def test_synthetic_batches_match_jax(seed, vocab, n_hosts, host_id):
    kw = dict(seq_len=24, global_batch=8, vocab_size=vocab, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    want, got = JP.SyntheticLM(JP.DataConfig(**kw)), \
        P.SyntheticLM(P.DataConfig(**kw))
    assert P.DataConfig(**kw).host_batch == 8 // n_hosts
    for step in (0, 1, 17, 1000):
        a, b = want.batch(step), got.batch(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert np.array_equal(a[k], b[k]), (k, step)
        assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_batches_match_jax(tmp_path, dtype):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(dtype) \
        .tofile(path)
    for seed, host in ((0, 0), (5, 1)):
        kw = dict(seq_len=32, global_batch=6, vocab_size=60000, seed=seed,
                  n_hosts=2, host_id=host)
        want = JP.MemmapCorpus(JP.DataConfig(**kw), path, dtype=dtype)
        got = P.MemmapCorpus(P.DataConfig(**kw), path, dtype=dtype)
        for step in (0, 3, 99):
            a, b = want.batch(step), got.batch(step)
            for k in a:
                assert np.array_equal(a[k], b[k]), (k, step)


def test_prefetcher_keeps_order_and_closes():
    src = P.SyntheticLM(P.DataConfig(seq_len=8, global_batch=2,
                                     vocab_size=50, seed=1))
    pf = P.Prefetcher(src, start_step=5, depth=2)
    try:
        for want in range(5, 12):
            step, batch = pf.next()
            assert step == want
            assert np.array_equal(batch["tokens"], src.batch(step)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert not any(t is pf._thread for t in threading.enumerate())
