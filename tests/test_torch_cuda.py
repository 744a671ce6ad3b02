"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need a CUDA card and skip without one (marker ``gpu``); run
them there with ``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.
The module imports nothing of JAX, so it also runs where JAX is absent.
The input generators and cases are shared with ``test_torch_arbiter.py``,
which holds the plain versions to the JAX package on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.arbiter import kernel
from repro_torch.kernels.arbiter.ref import (NEG, priority_arbiter_ref,
                                             srpt_topk_ref)


def _arb_inputs(H, cap, seed, *, n_prios=8, seq_hi=10_000, p_elig=0.3):
    """Random int32 rings in [0, BIG) with a bool eligibility mask; row 0
    is all-ineligible."""
    rng = np.random.default_rng(seed)
    prio = rng.integers(0, n_prios, (H, cap)).astype(np.int32)
    seq = rng.integers(0, seq_hi, (H, cap)).astype(np.int32)
    elig = rng.random((H, cap)) < p_elig
    elig[0] = False
    return prio, seq, elig


ARB_CASES = [
    # (H, cap, n_prios, seq_hi, p_elig)
    (8, 256, 8, 10_000, 0.3),
    (13, 100, 8, 10_000, 0.3),         # ragged
    (8, 1000, 8, 10_000, 0.5),         # ragged width
    (1, 1, 8, 10_000, 1.0),
    (6, 40, 2, 3, 0.7),                # dense (prio, seq) ties
    (5, 64, 1 << 30, 1 << 30, 0.5),    # full int32 range below BIG
    (4, 16, 8, 10_000, 0.0),           # every row empty
]


def _keys(H, M, seed, *, hi=1 << 28, p_pos=0.5, neg=False):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, (H, M)).astype(np.int32)
    keys = np.where(rng.random((H, M)) < p_pos, keys, 0).astype(np.int32)
    if neg:
        keys = np.where(rng.random((H, M)) < 0.3, NEG, keys).astype(np.int32)
    return keys


TOPK_CASES = [
    # (H, M, K, hi, p_pos, neg)
    (8, 512, 7, 1 << 28, 0.5, False),
    (13, 60, 5, 1 << 28, 0.5, False),   # ragged
    (4, 128, 1, 1 << 28, 0.5, False),
    (8, 300, 6, 3, 0.9, False),         # many tied keys
    (6, 3, 7, 100, 0.5, True),          # M < K with zeros and NEG keys
    (3, 1, 4, 100, 0.5, False),         # one column
    (5, 40, 4, 100, 0.0, False),        # all zero
    (4, 50, 3, (1 << 31) - 1, 1.0, False),  # full positive int32 range
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ARB_CASES + [(144, 1024, 8, 20_000, 0.5),
                                              (144, 512, 8, 20_000, 0.5)])
def test_priority_arbiter_kernel_matches_plain(cuda, case):
    H, cap, n_prios, seq_hi, p_elig = case
    args = [torch.from_numpy(a).to(cuda) for a in
            _arb_inputs(H, cap, 11, n_prios=n_prios, seq_hi=seq_hi,
                        p_elig=p_elig)]
    before = kernel.priority_arbiter.launches
    got = kernel.priority_arbiter(*args)
    want = priority_arbiter_ref(*args)
    torch.cuda.synchronize()
    assert kernel.priority_arbiter.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES + [(144, 8000, 7, 1 << 30, 0.05,
                                                False)])
def test_srpt_topk_kernel_matches_plain(cuda, case):
    H, M, K, hi, p_pos, neg = case
    keys = torch.from_numpy(_keys(H, M, 5, hi=hi, p_pos=p_pos,
                                  neg=neg)).to(cuda)
    before = kernel.srpt_topk.launches
    got = kernel.srpt_topk(keys, K)
    want = srpt_topk_ref(keys, K)
    torch.cuda.synchronize()
    assert kernel.srpt_topk.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs(cuda):
    p = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    e = torch.ones((4, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kernel.priority_arbiter(p.long(), p, e)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.priority_arbiter(p.t(), p.t(), e.t())
    with pytest.raises(ValueError, match="one shape"):
        kernel.priority_arbiter(p, p[:, :4].contiguous(), e)
