"""The port's SSD (``repro_torch.kernels.ssd``, ``models.ssm``) against the
JAX package on the CPU.

Inputs are drawn with numpy from a seed and given to both packages. On
the CPU the kernel wrapper runs its plain version (``ref.ssd_ref``), so
``ops.ssd`` here tests the padding and chunk choice around the kernel's
call site; ``test_torch_cuda.py`` holds the CUDA kernel to ``ssd_ref``
on a card with the same cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.ssd.ops import ssd as jssd
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import kernel as ssd_kernel, ops
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.models import ssm
from test_torch_cuda import SSD_CASES, _ssd_inputs

torch.set_num_threads(1)


def _both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_matches_jax(case):
    """The same sequential fp32 recurrence: only the order of the sum
    over N in ``C . state`` may differ, hence 1e-5."""
    B, S, H, P, N, _ = case
    t, j = _both(_ssd_inputs(B, S, H, P, N, 7))
    y, fs = ssd_ref(*t)
    yj, fj = jssd_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fj), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ops_ssd_matches_jax_kernel(case, bf16):
    """``ops.ssd`` (plain on the CPU) against JAX ``ssd`` running the
    Pallas kernel in interpret mode, pad path included; the tolerance is
    the JAX package's own for kernel vs oracle (5e-4). ``bf16`` feeds
    x/B/C as bf16, as the model does."""
    B, S, H, P, N, chunk = case
    arrays = _ssd_inputs(B, S, H, P, N, 7, bf16=bf16)
    t, j = _both(arrays)
    if bf16:
        t = [t[0].bfloat16(), t[1], t[2], t[3].bfloat16(), t[4].bfloat16()]
        j = [j[0].astype(jnp.bfloat16), j[1], j[2],
             j[3].astype(jnp.bfloat16), j[4].astype(jnp.bfloat16)]
    before = ssd_kernel.ssd_scan.launches
    y, fs = ops.ssd(*t, chunk=chunk)
    assert ssd_kernel.ssd_scan.launches == before     # plain version
    yj, fj = jssd(*j, chunk=chunk, interpret=True)
    assert y.shape == yj.shape and fs.shape == fj.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fj), atol=5e-4,
                               rtol=5e-4)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_jax(case):
    """The same chunked fp32 algorithm in both packages: 1e-5."""
    B, S, H, P, N, chunk = case
    t, j = _both(_ssd_inputs(B, S, H, P, N, 3))
    y, fs = ssm.ssd_chunked(*t, chunk)
    yj, fj = jssm.ssd_chunked(*j, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fj), atol=1e-5,
                               rtol=1e-5)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    state = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((2, 3))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(3)).astype(np.float32)
    Bv, Cv = (rng.standard_normal((2, 16)).astype(np.float32)
              for _ in range(2))
    args = (state, x, dt, A, Bv, Cv)
    t, j = _both(args)
    y, ns = ssm.ssd_decode_step(*t)
    yj, nj = jssm.ssd_decode_step(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ns.numpy(), np.asarray(nj), atol=1e-6,
                               rtol=1e-6)


def test_segsum_decay_is_lower_triangular_and_finite():
    """Large cumulative decays: the exponent is taken only where i >= j,
    so nothing overflows above the diagonal (zeros there), as JAX's."""
    dA = torch.full((2, 64), -30.0)
    d = ssm.segsum_decay(dA)
    dj = np.asarray(jssm.segsum_decay(jnp.asarray(dA.numpy())))
    assert torch.isfinite(d).all()
    assert (torch.triu(d, 1) == 0).all()
    # XLA on the CPU flushes subnormal results to zero; torch keeps them
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-6, atol=1.2e-38)


def test_padded_steps_leave_the_state_alone():
    """``ops.ssd`` pads with dt = 0: the final state is the unpadded
    sequence's and y is cut back to S."""
    t, _ = _both(_ssd_inputs(1, 45, 2, 8, 16, 9))
    y, fs = ops.ssd(*t, chunk=16)                  # 45 -> 48
    yr, fr = ssd_ref(*t)
    assert y.shape == yr.shape
    np.testing.assert_allclose(fs.numpy(), fr.numpy(), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=1e-6, rtol=1e-6)


def test_chunk_choice_matches_jax():
    """``c = min(chunk, S) if S % min(chunk, S) == 0 else chunk``: a short
    sequence is one chunk of its own length; a ragged one pads."""
    seen = []
    real = ops.ssd_scan

    def spy(x, dt, A, Bm, Cm, *, chunk):
        seen.append((x.shape[1], chunk))
        return real(x, dt, A, Bm, Cm, chunk=chunk)

    ops.ssd_scan = spy
    try:
        for S, chunk in ((20, 256), (48, 16), (45, 16), (300, 256)):
            t, _ = _both(_ssd_inputs(1, S, 1, 4, 4, 1))
            ops.ssd(*t, chunk=chunk)
    finally:
        ops.ssd_scan = real
    assert seen == [(20, 20), (48, 16), (48, 16), (512, 256)]


def test_kernel_wrapper_checks_the_chunk_on_the_cpu():
    t, _ = _both(_ssd_inputs(1, 30, 1, 4, 4, 1))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_kernel.ssd_scan(*t, chunk=8)


def test_cpu_inputs_that_require_grad_take_the_plain_path():
    """A CPU call keeps its gradients (the plain version), launches
    nothing, and its gradients are ssd_ref's; on a card the same call
    raises (``test_torch_cuda.py``)."""
    args = [torch.tensor(a, requires_grad=True)
            for a in _ssd_inputs(1, 16, 2, 4, 4, 2)]
    n = ssd_kernel.ssd_scan.launches
    y, fs = ssd_kernel.ssd_scan(*args, chunk=8)
    (y.square().sum() + fs.sum()).backward()
    got = [a.grad for a in args]
    ref = [a.detach().clone().requires_grad_() for a in args]
    yr, fr = ssd_ref(*ref)
    (yr.square().sum() + fr.sum()).backward()
    assert ssd_kernel.ssd_scan.launches == n
    assert all(g is not None and torch.equal(g, r.grad)
               for g, r in zip(got, ref))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_ssd_decay_property(seed):
    """With A << 0 (fast decay) the state forgets: doubling early inputs
    must not change late outputs materially — for the port's ``ops.ssd``
    and ``ssd_chunked``, and as for JAX's ``ssd``."""
    rng = np.random.default_rng(seed)
    B, S, H, P, N = 1, 32, 1, 4, 4
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 2.0, np.float32)
    A = np.full((H,), -8.0, np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    x2 = x.copy()
    x2[:, :8] *= 2.0
    for fn in (lambda *a: ops.ssd(*a, chunk=8),
               lambda *a: ssm.ssd_chunked(*a, 8)):
        y1, _ = fn(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)))
        y2, _ = fn(*(torch.from_numpy(a) for a in (x2, dt, A, Bm, Cm)))
        np.testing.assert_allclose(y1[:, -8:].numpy(), y2[:, -8:].numpy(),
                                   atol=1e-3)
    yj, _ = jssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=8,
                 interpret=True)
    np.testing.assert_allclose(y1.numpy(), np.asarray(yj), atol=5e-4,
                               rtol=5e-4)
