"""The port's arbitration kernels against the JAX package.

The plain PyTorch versions (``repro_torch.kernels.arbiter.ref``) must
equal ``repro.kernels.arbiter.ref`` and the Pallas kernels in interpret
mode exactly, on random int32 inputs, ties, empty rows, ragged shapes and
M < K (the cases of ``test_torch_cuda.py``, which holds the hand-written
CUDA kernels to the plain versions on a card). On the CPU the wrappers
take the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arbiter import ops as jops
from repro.kernels.arbiter import ref as jref
from repro_torch.kernels.arbiter import dispatch, kernel
from repro_torch.kernels.arbiter.ref import (BIG, fused_slot_ref,
                                             priority_arbiter_ref,
                                             ring_insert_ref, srpt_topk_ref)
from test_torch_cuda import ARB_CASES, TOPK_CASES, _arb_inputs, _keys

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ARB_CASES)
def test_priority_arbiter_plain_matches_jax(case):
    H, cap, n_prios, seq_hi, p_elig = case
    prio, seq, elig = _arb_inputs(H, cap, H * cap, n_prios=n_prios,
                                  seq_hi=seq_hi, p_elig=p_elig)
    tp, ti = priority_arbiter_ref(torch.from_numpy(prio),
                                  torch.from_numpy(seq),
                                  torch.from_numpy(elig))
    assert tp.dtype == ti.dtype == torch.int32
    args = (jnp.asarray(prio), jnp.asarray(seq), jnp.asarray(elig))
    for jp, ji in (jref.priority_arbiter_ref(*args),
                   jops.arbitrate(*args, interpret=True)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (tp[0] == BIG) and (ti[0] == 0)      # empty row: (BIG, 0)


@pytest.mark.parametrize("case", TOPK_CASES)
def test_srpt_topk_plain_matches_jax(case):
    H, M, K, hi, p_pos, neg = case
    keys = _keys(H, M, H + M + K, hi=hi, p_pos=p_pos, neg=neg)
    tv, ti = srpt_topk_ref(torch.from_numpy(keys), K)
    assert tv.dtype == ti.dtype == torch.int32
    assert tv.shape == ti.shape == (H, K)
    jk = jnp.asarray(keys)
    for jv, ji in (jref.srpt_topk_ref(jk, K),
                   jops.topk(jk, K, interpret=True)):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the kernel wrappers (the fused ones and the ring
    insert included) and the ``cuda`` dispatch path compute the plain
    version and launch nothing."""
    kernel.reset_launch_counts()
    prio, seq, elig = (torch.from_numpy(a) for a in _arb_inputs(8, 64, 3))
    want = priority_arbiter_ref(prio, seq, elig)
    for got in (kernel.priority_arbiter(prio, seq, elig),
                dispatch.arbitrate(prio, seq, elig, backend="cuda")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    keys = torch.from_numpy(_keys(8, 64, 4))
    want = srpt_topk_ref(keys, 3)
    for got in (kernel.srpt_topk(keys, 3),
                dispatch.topk(keys, 3, backend="cuda")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = fused_slot_ref((prio, seq, elig), None, keys, 3)
    got = kernel.fused_slot(down=(prio, seq, elig), keys=keys, K=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = kernel.fused_slot_batch(down=(prio[None], seq[None], elig[None]),
                                  keys=keys[None], K=3)
    assert all(torch.equal(g[0], w) for g, w in zip(got, want))
    rings = (prio[None], seq[None], seq[None], elig[None])
    items = (torch.arange(8, dtype=torch.int32)[None] % 3,
             torch.ones((1, 8), dtype=torch.bool), *(prio[None, :, 0],) * 3)
    want = ring_insert_ref(*rings, *items)
    for got in (kernel.ring_insert(*rings, *items),
                dispatch.insert(*rings, *items, backend="cuda")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernel.launch_counts() == {"priority_arbiter": 0, "srpt_topk": 0,
                                      "fused_slot": 0, "fused_slot_batch": 0,
                                      "ring_insert": 0}
    assert kernel.srpt_topk(keys, 40)[0].shape == (8, 40)    # rounds' K
    assert all(fn.launches_rounds == 0 for fn in kernel.TOPK_WRAPPERS)
    with pytest.raises(ValueError, match="K must be >= 1"):
        kernel.srpt_topk(keys, 0)


def test_torch_topk_is_not_the_oracle():
    """``torch.topk`` promises no tie order, which is why the plain version
    sorts stably: on tied keys the stable sort gives the lowest columns."""
    keys = torch.zeros((1, 64), dtype=torch.int32)
    keys[0, 10:] = 7
    vals, idx = srpt_topk_ref(keys, 3)
    assert vals.tolist() == [[7, 7, 7]] and idx.tolist() == [[10, 11, 12]]
