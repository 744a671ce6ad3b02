"""A plain-torch model of the tensor-core SSD route's arithmetic, held to
the plain version and to the JAX package on the CPU.

``csrc/ssd.cu``'s tensor-core kernels cannot run here, so this file models
what they compute, in their order, and checks that the design computes
the function before a card runs it:

* per chunk, the scan of dt * A (cums) and the decay exp(cums_L);
* ``ssd_chunk_state_tc_kernel``: w_l = dt_l exp(cums_L - cums_l), w x
  split into bf16 hi + lo, the chunk's state (w x)_hi^T B + (w x)_lo^T B
  over 64-row sub-tiles;
* ``ssd_state_pass_tc_kernel``: the fp32 recurrence over chunks, the
  state before each chunk split into bf16 hi + lo;
* ``ssd_output_tc_kernel``: per 64-row tile of a chunk, s = C B_j^T over
  the key tiles j0 <= i0 (tiles above the diagonal skipped), att = s
  exp(cums_i - cums_j) dt_j masked to j <= i — on tiles below the
  diagonal with the decay factored about the tile's last key m,
  exp(cums_i - cums_m) (exp(cums_m - cums_j) dt_j), both exponents <= 0
  — split into hi + lo, att_hi x + att_lo x, plus exp(cums_i) (C st_hi
  + C st_lo).

Every product has bf16 factors (exact in fp32, as on the tensor cores)
and every sum is fp32. With ``terms=1`` the three fp32 factors are
rounded to bf16 once instead: a different function, which must fail the
kernel's tolerance (``SSD_ATOL``/``SSD_RTOL``) while the two-term design
stays well inside it. Run with ``PYTHONPATH=src python -m pytest
tests/test_torch_ssd_design.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd.ops import ssd as jssd
from repro_torch.kernels.ssd.kernel import TC_TILE, takes_tensor_cores
from repro_torch.kernels.ssd.ref import ssd_ref
from test_torch_cuda import (SSD_ATOL, SSD_KERNEL_CASES, SSD_RTOL,
                             SSD_TC_CASES, _ssd_inputs)

torch.set_num_threads(1)

T = TC_TILE  # the kernels' tile rows
# the share of the tolerance the two-term design may use here (it uses
# about 0.07 on y and 0.01 on the state at S 2048, H 3, P 64, N 128,
# chunk 256): a fourfold margin
MARGIN = 0.25


def split(v: torch.Tensor, terms: int):
    """v as bf16 terms: [bf16(v)] or [hi, bf16(v - hi)], as fp32."""
    hi = v.bfloat16().float()
    return [hi] if terms == 1 else [hi, (v - hi).bfloat16().float()]


def tc_model(x, dt, A, Bm, Cm, chunk: int, terms: int = 2,
             scan=torch.float64):
    """The tensor-core route of ``ssd_scan`` in plain torch. x/Bm/Cm hold
    bf16 values; returns (y (B,S,H,P), final state (B,H,P,N)), fp32. The
    chunk's scan of dt * A runs in ``scan`` (the kernels': float64), and
    each exponent is a difference of its values, rounded to fp32 before
    the fp32 exp."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L, nc = chunk, S // chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    y = torch.empty((B, S, H, P))
    st = torch.zeros((B, H, P, N))
    for c in range(nc):
        rows = slice(c * L, (c + 1) * L)
        xc, Bc, Cc = xf[:, rows], Bf[:, rows], Cf[:, rows]  # (B,L,H,P) (B,L,N)
        dtc = dtf[:, rows].permute(0, 2, 1)                 # (B,H,L)
        cums = torch.cumsum((dtc * A.float()[None, :, None]).to(scan), -1)
        last = cums[..., -1:]

        def ex(d):      # exp of a difference of scan values, in fp32
            return torch.exp(d.float())

        # the chunk's state, over 64-row sub-tiles of w x split in two
        w = dtc * ex(last - cums)                            # (B,H,L)
        own = torch.zeros((B, H, P, N))
        for u in range(0, L, T):
            wx = (w[..., u:u + T, None]
                  * xc[:, u:u + T].permute(0, 2, 1, 3))      # (B,H,T,P)
            for part in split(wx, terms):
                own = own + part.transpose(-1, -2) @ Bc[:, None, u:u + T]
        before = split(st, terms)       # the state before this chunk
        st = ex(last)[..., None] * st + own
        # outputs, per 64-row tile of the chunk
        for i0 in range(0, L, T):
            ci = Cc[:, i0:i0 + T]                                # (B,T,N)
            acc = torch.zeros((B, H, T, P))
            for j0 in range(0, i0 + T, T):                       # j0 <= i0
                s = ci @ Bc[:, j0:j0 + T].transpose(1, 2)        # (B,T,T)
                dtj = dtc[..., None, j0:j0 + T]
                if j0 < i0:
                    # below the diagonal: the decay factored about the
                    # tile's last key m, both exponents <= 0
                    cm = cums[..., j0 + T - 1, None, None]
                    rowf = ex(cums[..., i0:i0 + T, None] - cm)
                    keyf = ex(cm - cums[..., None, j0:j0 + T]) * dtj
                    att = s[:, None] * (rowf * keyf)
                else:
                    i = torch.arange(i0, i0 + T)[:, None]
                    j = torch.arange(j0, j0 + T)[None, :]
                    decay = ex(cums[..., i0:i0 + T, None]
                               - cums[..., None, j0:j0 + T])
                    att = torch.where(j <= i, s[:, None] * decay * dtj,
                                      torch.zeros(()))
                xj = xc[:, j0:j0 + T].permute(0, 2, 1, 3)        # (B,H,T,P)
                for part in split(att, terms):
                    acc = acc + part @ xj
            if c > 0:
                inter = sum(ci[:, None] @ half.transpose(-1, -2)
                            for half in before)                  # (B,H,T,P)
                acc = acc + ex(cums[..., i0:i0 + T, None]) * inter
            y[:, c * L + i0:c * L + i0 + T] = acc.permute(0, 2, 1, 3)
    return y, st


def _used(got, want) -> float:
    """The largest share of SSD_ATOL + SSD_RTOL |want| used."""
    return float(((got - want).abs()
                  / (SSD_ATOL + SSD_RTOL * want.abs())).max())


def _tensors(arrays):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    return x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16()


# (B, S, H, P, N, chunk): the model's widths at S 2048, and a narrower P
# with a shorter chunk
DESIGN_CASES = [(1, 2048, 3, 64, 128, 256), (2, 512, 2, 40, 128, 128)]


@pytest.fixture(scope="module")
def main_case():
    args = _tensors(_ssd_inputs(*DESIGN_CASES[0][:5], 7, bf16=True))
    return args, ssd_ref(*args)


@pytest.mark.parametrize("case", DESIGN_CASES)
def test_two_term_design_matches_ssd_ref(case, main_case):
    """The design computes ssd_ref's function within a quarter of the
    kernel's tolerance, y and the final state."""
    if case == DESIGN_CASES[0]:
        args, (yr, fr) = main_case
    else:
        args = _tensors(_ssd_inputs(*case[:5], 7, bf16=True))
        yr, fr = ssd_ref(*args)
    y, fs = tc_model(*args, case[-1])
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    assert _used(y, yr) <= MARGIN, _used(y, yr)
    assert _used(fs, fr) <= MARGIN, _used(fs, fr)


def test_one_bf16_term_is_another_function(main_case):
    """Rounding att, w x and the carried state to one bf16 term each
    moves y well past the tolerance: the split is needed."""
    args, (yr, fr) = main_case
    y1, fs1 = tc_model(*args, 256, terms=1)
    y2, _ = tc_model(*args, 256, terms=2)
    assert _used(y1, yr) > 5.0, _used(y1, yr)
    assert _used(y1, yr) > 50 * _used(y2, yr)
    assert _used(fs1, fr) > 1.0, _used(fs1, fr)


def test_design_matches_the_jax_kernel():
    """Against the JAX package's ``ssd`` running ``ssd_pallas`` in
    interpret mode (its own tolerance for kernel vs oracle, 5e-4)."""
    B, S, H, P, N, L = 1, 1024, 2, 64, 128, 256
    arrays = _ssd_inputs(B, S, H, P, N, 11, bf16=True)
    y, fs = tc_model(*_tensors(arrays), L)
    j = [jnp.asarray(a) for a in arrays]
    j = [j[0].astype(jnp.bfloat16), j[1], j[2], j[3].astype(jnp.bfloat16),
         j[4].astype(jnp.bfloat16)]
    yj, fj = jssd(*j, chunk=L, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(fs.numpy(), np.asarray(fj), atol=5e-4,
                               rtol=5e-4)


@pytest.mark.parametrize("dt_scale,a_mu", [(20.0, 2.0), (200.0, 4.0)])
def test_strong_decay_underflows_cleanly(dt_scale, a_mu):
    """Large dt and strongly negative A: cums reaches far below -1e3, so
    exp(cums_i) and exp(cums_L - cums_l) underflow to 0 and only the
    stable exp(cums_i - cums_j) of nearby steps survives. Nothing
    overflows (no inf, no NaN) and the design still matches ssd_ref."""
    x, dt, A, Bm, Cm = _tensors(_ssd_inputs(1, 512, 2, 64, 128, 3,
                                            bf16=True))
    dt, A = dt * dt_scale, A * np.exp(a_mu)
    cums = torch.cumsum(dt[0, :256, 0] * A[0], 0)
    assert float(cums[-1]) < -1e3
    y, fs = tc_model(x, dt, A, Bm, Cm, 256)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    assert _used(y, yr) <= MARGIN and _used(fs, fr) <= MARGIN


def test_scan_in_float64_under_strong_decay():
    """Why the kernels scan dt * A in float64: with dt x 20 and A x e^2
    the chunk's cums reaches ~-3e4, where an fp32 scan is off by more
    than 1e-3, so exp(cums_i - cums_j) of two nearby steps is off by that
    share of itself. The JAX package's ``ssd_pallas`` scans in fp32 and shares
    that error; the float64 scan leaves the exponents exact and y well
    inside the tolerance, the fp32 one uses far more of it."""
    x, dt, A, Bm, Cm = _tensors(_ssd_inputs(1, 2048, 3, 64, 128, 3,
                                            bf16=True))
    dt, A = dt * 20.0, A * np.exp(2.0)
    dA = (dt[0] * A).reshape(8, 256, 3)            # chunks, steps, heads
    exact = torch.cumsum(dA.double(), 1)
    assert float(exact[:, -1].max()) < -1e4
    assert float((torch.cumsum(dA, 1).double() - exact).abs().max()) > 1e-3
    assert float((torch.cumsum(dA.double(), 1) - exact).abs().max()) < 1e-9
    yr, fr = ssd_ref(x, dt, A, Bm, Cm)
    y64, fs64 = tc_model(x, dt, A, Bm, Cm, 256)
    y32, _ = tc_model(x, dt, A, Bm, Cm, 256, scan=torch.float32)
    assert _used(y64, yr) <= MARGIN and _used(fs64, fr) <= MARGIN
    assert _used(y32, yr) > 10 * _used(y64, yr)


def test_padded_steps_leave_the_design_alone():
    """``ops.ssd`` pads S to a multiple of the chunk with dt = 0: the
    padded steps neither decay nor add to the state, so the design's
    final state is the unpadded sequence's and its first S rows of y
    are ssd_ref's."""
    x, dt, A, Bm, Cm = _tensors(_ssd_inputs(1, 1000, 2, 64, 128, 5,
                                            bf16=True))
    pad = 24
    y, fs = tc_model(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                     A, F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)),
                     256)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm)
    assert _used(y[:, :1000], yr) <= MARGIN
    assert _used(fs, fr) <= MARGIN


@pytest.mark.parametrize("case", SSD_KERNEL_CASES)
def test_route_rule(case):
    """``takes_tensor_cores`` sends ``SSD_TC_CASES`` (the model's P 64, N
    128, chunk 256, and a P 40, chunk 128 case) to the tensor cores; the JAX
    package's small cases, the reduced config (P 8, N 16, chunk 8), a
    chunk not a multiple of 64 and P or N beyond the route's widths to
    the CUDA cores. (``ops.ssd`` makes a sequence shorter than its chunk
    one chunk of its own length.)"""
    B, S, H, P, N, chunk = case
    c = min(chunk, S) if S % min(chunk, S) == 0 else chunk
    x, _, _, Bm, Cm = _tensors(_ssd_inputs(B, S, H, P, N, 0))
    assert takes_tensor_cores(x, Bm, Cm, c) == (case in SSD_TC_CASES)


def test_route_rule_needs_aligned_rows():
    """TMA loads 16-byte aligned rows: a tensor starting 2 bytes off a
    16-byte boundary, or a P that is not a multiple of 8, takes the CUDA
    cores; so do N 64 or 256 (the kernels are built for N 128) and a
    chunk of 512 (the output kernel holds a whole chunk of at most 256
    rows in shared memory)."""
    x, _, _, Bm, Cm = _tensors(_ssd_inputs(1, 512, 1, 64, 128, 0))
    assert takes_tensor_cores(x, Bm, Cm, 256)
    assert takes_tensor_cores(x, Bm, Cm, 64)
    assert not takes_tensor_cores(x, Bm, Cm, 512)
    assert not takes_tensor_cores(x, Bm, Cm, 96)
    buf = torch.empty(Bm.numel() + 8, dtype=Bm.dtype)
    off = buf[1:1 + Bm.numel()].view(Bm.shape)
    assert off.data_ptr() % 16 == 2
    assert not takes_tensor_cores(x, off, Cm, 256)
    x, _, _, Bm, Cm = _tensors(_ssd_inputs(1, 256, 1, 36, 128, 0))
    assert not takes_tensor_cores(x, Bm, Cm, 256)
    for n in (64, 256):
        x, _, _, Bm, Cm = _tensors(_ssd_inputs(1, 256, 1, 64, n, 0))
        assert not takes_tensor_cores(x, Bm, Cm, 256)
