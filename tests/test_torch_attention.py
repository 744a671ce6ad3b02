"""The port's flash attention (``repro_torch.kernels.attention``) against
the JAX package on the CPU.

Inputs are drawn with numpy from a seed and given to both packages. On
the CPU the kernel wrapper runs its plain version (``ref.attention_ref``),
so ``ops.attention`` here tests the block choice and padding around the
kernel's call site; ``test_torch_cuda.py`` holds the CUDA kernel to
``attention_ref`` on a card with the same cases. Tolerances are the JAX
package's own for kernel vs oracle (``tests/test_kernels.py``): 2e-5 on
fp32 inputs, 2e-2 on bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.attention.kernel import flash_attention as jflash
from repro.kernels.attention.ops import attention as jattention
from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.attention import kernel as attn_kernel, ops
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.attention.ref import NEG_INF, attention_ref
from test_torch_cuda import (ATTN_CASES, ATTN_KERNEL_CASES, ATTN_TOL,
                             _attn_inputs, _chip_smoke)

torch.set_num_threads(1)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _both(arrays, dtype):
    """The same values in both packages (bf16 rounded once, by torch)."""
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return t, [jnp.asarray(x.float().numpy()).astype(JDT[dtype]) for x in t]


def _close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_KERNEL_CASES)
def test_attention_ref_matches_jax(case):
    """Both oracles: fp32 naive attention, the same masks and the same
    NEG_INF sentinel (so rows with no valid key average v alike)."""
    B, Sq, Skv, H, KV, d, causal, window, dtype = case
    t, j = _both(_attn_inputs(B, Sq, Skv, H, KV, d, 42), dtype)
    _close(attention_ref(*t, causal=causal, window=window),
           jattention_ref(*j, causal=causal, window=window), dtype)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_ops_attention_matches_jax_kernel(case):
    """``ops.attention`` (plain on the CPU, pad path included) against
    JAX ``attention`` running the Pallas kernel in interpret mode, with
    the blocks of the JAX package's test; no launch is counted."""
    B, Sq, Skv, H, KV, d, causal, window, dtype = case
    t, j = _both(_attn_inputs(B, Sq, Skv, H, KV, d, 42), dtype)
    before = attn_kernel.flash_attention.launches
    got = ops.attention(*t, causal=causal, window=window, block_q=32,
                        block_kv=32)
    assert attn_kernel.flash_attention.launches == before
    assert got.dtype == TDT[dtype] and got.shape == (B, Sq, H, d)
    _close(got, jattention(*j, causal=causal, window=window, block_q=32,
                           block_kv=32, interpret=True), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", [1, 21, 40])
def test_kv_len_matches_jax_kernel(causal, kv_len):
    """``kv_len`` < Skv masks the tail keys, as JAX's kernel does."""
    t, j = _both(_attn_inputs(2, 48, 48, 4, 2, 16, 5), "f32")
    got = flash_attention(*t, causal=causal, kv_len=kv_len)
    _close(got, jflash(*j, causal=causal, kv_len=kv_len, block_q=16,
                       block_kv=16, interpret=True), "f32")
    _close(got, jattention_ref(*j, causal=causal, kv_len=kv_len), "f32")


def test_row_with_no_valid_key_averages_v():
    """Non-causal, window 8, kv_len 10: queries 17.. see no valid key and
    average v over all 64 keys uniformly — in the port, in JAX's oracle
    and in JAX's kernel alike (a finite NEG_INF, never -inf: no NaN)."""
    t, j = _both(_attn_inputs(1, 64, 64, 2, 1, 16, 9), "f32")
    got = flash_attention(*t, causal=False, window=8, kv_len=10)
    assert torch.isfinite(got).all()
    mean_v = t[2].mean(1, keepdim=True).expand(-1, 47, 2, -1)
    torch.testing.assert_close(got[:, 17:], mean_v, atol=2e-6, rtol=2e-6)
    _close(got, jattention_ref(*j, causal=False, window=8, kv_len=10),
           "f32")
    _close(got, jflash(*j, causal=False, window=8, kv_len=10, block_q=16,
                       block_kv=16, interpret=True), "f32")


def test_causal_rows_without_valid_key_follow_the_oracle():
    """Causal, window 2, kv_len 8: queries 9.. see no valid key. The port
    averages all 64 keys, as JAX's oracle does; JAX's kernel averages only
    the blocks up to the diagonal, so its rows 9..47 (q blocks 0-2 of 16)
    differ from its own oracle — the model never builds such a row."""
    t, j = _both(_attn_inputs(1, 64, 64, 1, 1, 8, 0), "f32")
    got = flash_attention(*t, causal=True, window=2, kv_len=8)
    _close(got, jattention_ref(*j, causal=True, window=2, kv_len=8), "f32")
    jk = np.asarray(jflash(*j, causal=True, window=2, kv_len=8, block_q=16,
                           block_kv=16, interpret=True))
    rows = np.abs(jk - got.numpy()).max(axis=(0, 2, 3)) > 1e-5
    assert np.flatnonzero(rows).tolist() == list(range(9, 48))


def test_first_tiles_fully_masked():
    """Causal window 4 over 64 keys in blocks of 16: the first tiles a
    late query sees are all masked (p = 1 there) until a valid key wipes
    them out with corr = 0, as in the JAX kernel."""
    t, j = _both(_attn_inputs(1, 64, 64, 2, 2, 8, 11), "f32")
    got = ops.attention(*t, causal=True, window=4, block_q=16, block_kv=16)
    _close(got, jattention(*j, causal=True, window=4, block_q=16,
                           block_kv=16, interpret=True), "f32")


def _convex(b, kv, g, d, causal, seed):
    """Rows of the attention output are convex combinations of V rows:
    the output lies within [min(v), max(v)]."""
    q, k, v = (torch.from_numpy(a) for a in
               _attn_inputs(b, 40, 40, kv * g, kv, d, seed))
    out = ops.attention(q, k, v, causal=causal, block_q=16, block_kv=16)
    assert torch.isfinite(out).all()
    assert out.max() <= v.max() + 1e-3 and out.min() >= v.min() - 1e-3


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4), st.integers(1, 3),
       st.sampled_from([8, 16, 32]), st.booleans())
def test_attention_property(b, kv, g, d, causal):
    _convex(b, kv, g, d, causal, b * 100 + kv * 10 + g)


@pytest.mark.parametrize("b,kv,g,d,causal", [(1, 1, 3, 8, True),
                                             (3, 2, 2, 32, False),
                                             (2, 4, 1, 16, True)])
def test_attention_convex_cases(b, kv, g, d, causal):
    """The property test's check on fixed draws, so it runs where
    hypothesis is not installed."""
    _convex(b, kv, g, d, causal, 7)


def test_wrapper_rejects_other_devices():
    """The wrapper runs its plain version only for a CPU tensor and
    raises on a device that is neither CPU nor CUDA."""
    x = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(x, x, x)


def test_cpu_inputs_that_require_grad_take_the_plain_path():
    """A CPU call keeps its gradients (the plain version), launches
    nothing, and its gradients are attention_ref's; on a card the same
    call raises (``test_torch_cuda.py``)."""
    qkv = [torch.tensor(a, requires_grad=True)
           for a in _attn_inputs(1, 16, 16, 2, 1, 8, 4)]
    n = attn_kernel.flash_attention.launches
    flash_attention(*qkv, causal=True).square().sum().backward()
    got = [t.grad for t in qkv]
    ref = [t.detach().clone().requires_grad_() for t in qkv]
    attention_ref(*ref, causal=True).square().sum().backward()
    assert attn_kernel.flash_attention.launches == n
    assert all(torch.equal(g, r.grad) for g, r in zip(got, ref))


# ------------------- the tensor-core kernel's arithmetic, modelled ----

def _tc_model(q, k, v, *, causal=True, window=None, kv_len=None,
              split=True, block=128, block_k=None):
    """A plain-torch model of ``flash_attention_tc_kernel``'s arithmetic:
    per 128-row q block, the key tiles of ``block_k`` keys (default
    ``block``: the narrow design's 128; the wide design's 112) its masks
    need (every tile when a
    row has no valid key), bf16 q.k with exact products summed in fp32,
    the online softmax with the finite NEG_INF, l summed from the fp32 p,
    and p.V as p_hi.V + p_lo.V with p_hi = bf16(p), p_lo = bf16(p - p_hi)
    (``split=False``: p_hi.V alone, p rounded to bf16 as SDPA does).
    Returns (B, Sq, H, dv) in fp32, before the output's rounding."""
    B, Sq, H, d = q.shape
    _, Skv, KV, dv = v.shape
    G = H // KV
    bk = block if block_k is None else block_k
    scale = 1.0 / np.sqrt(d)
    kv_len = Skv if kv_len is None else kv_len
    valid_hi = min(Skv, kv_len)
    kf = k.float().repeat_interleave(G, dim=2)      # (B, Skv, H, d)
    vf = v.float().repeat_interleave(G, dim=2)
    out = torch.empty((B, Sq, H, dv))
    n_tiles = -(-Skv // bk)
    for q0 in range(0, Sq, block):
        rows = torch.arange(q0, min(q0 + block, Sq))
        hi = torch.full_like(rows, valid_hi)
        if causal:
            hi = torch.minimum(hi, rows + 1)
        lo = (rows - window + 1).clamp_min(0) if window is not None \
            else torch.zeros_like(rows)
        if bool((lo >= hi).any()):
            t0, t1 = 0, n_tiles
        else:
            kv_hi = min(min(Skv, q0 + block) if causal else Skv, valid_hi)
            t0 = max(0, q0 - window + 1) // bk if window is not None \
                else 0
            t1 = -(-kv_hi // bk)
        qf = q[:, q0:q0 + len(rows)].float()
        m = torch.full((B, len(rows), H), NEG_INF)
        l = torch.zeros((B, len(rows), H))
        acc = torch.zeros((B, len(rows), H, dv))
        for t in range(t0, t1):
            keys = torch.arange(t * bk, min((t + 1) * bk, Skv))
            s = torch.einsum("bqhd,bjhd->bqhj", qf, kf[:, keys]) * scale
            ok = keys[None, :] < kv_len
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window is not None:
                ok = ok & (keys[None, :] > rows[:, None] - window)
            s = torch.where(ok[None, :, None, :], s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            p_hi = p.bfloat16().float()
            pv = torch.einsum("bqhj,bjhd->bqhd", p_hi, vf[:, keys])
            if split:
                p_lo = (p - p_hi).bfloat16().float()
                pv = pv + torch.einsum("bqhj,bjhd->bqhd", p_lo, vf[:, keys])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, q0:q0 + len(rows)] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _rel_rms(got, want):
    """(relative RMS over the whole output, worst query row)."""
    diff = got.float() - want.float()
    rows = diff.norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
    return float(diff.norm() / want.float().norm()), float(rows.max())


def test_tc_arithmetic_split_is_fp32_exact_and_bf16_p_is_not():
    """At (1, 1024, 4 heads over 2, d 128), bf16, causal: the split
    p_hi + p_lo keeps the kernel within ATTN_RMS_TOL of both oracles
    (the torch and the JAX ``attention_ref``); p rounded to bf16 alone,
    as SDPA computes it, lands above that bound — another function."""
    tol = _chip_smoke().ATTN_RMS_TOL["bfloat16"]
    t, j = _both(_attn_inputs(1, 1024, 1024, 4, 2, 128, 3), "bf16")
    want = attention_ref(*t)
    want_jax = torch.from_numpy(np.array(
        jattention_ref(*j).astype(jnp.float32)))
    exact = attention_ref(*(x.float() for x in t))
    split = _tc_model(*t)
    bf16_p = _tc_model(*t, split=False)
    # before the output's rounding: the split leaves ~1e-6, bf16 p ~1e-3
    assert _rel_rms(split, exact)[0] < 1e-5
    assert _rel_rms(bf16_p, exact)[0] > 5e-4
    for oracle in (want, want_jax):
        rms, row = _rel_rms(split.bfloat16(), oracle)
        assert rms <= tol["rms"] and row <= tol["row"], (rms, row)
        assert _rel_rms(bf16_p.bfloat16(), oracle)[0] > tol["rms"]


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (False, None, 150), (True, 40, None),
    (False, 2, 8), (True, 2, 8), (True, None, 37)])
def test_tc_tile_range_matches_the_oracle(causal, window, kv_len):
    """The kernel's choice of key tiles per 128-row block — up to the
    last valid key, from the first under a window, or every tile when a
    row has no valid key (rows 9.. with window 2, kv_len 8) — gives
    ``attention_ref``'s function, starved rows averaging all keys."""
    t, j = _both(_attn_inputs(2, 300, 300, 4, 2, 32, 13), "f32")
    got = _tc_model(*t, causal=causal, window=window, kv_len=kv_len)
    _close(got, jattention_ref(*j, causal=causal, window=window,
                               kv_len=kv_len), "f32")
    torch.testing.assert_close(
        got, attention_ref(*t, causal=causal, window=window, kv_len=kv_len),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,dtype,offset,tc", [
    ((128, 128), torch.bfloat16, 0, True),
    ((64, 64), torch.bfloat16, 0, True),
    ((128, 64), torch.bfloat16, 0, True),
    ((128, 128), torch.float32, 0, False),
    ((20, 20), torch.bfloat16, 0, False),
    ((64, 12), torch.bfloat16, 0, False),
    ((128, 128), torch.bfloat16, 1, False),
    ((192, 128), torch.bfloat16, 0, True),       # MLA
    ((192, 64), torch.bfloat16, 0, True),
    ((160, 128), torch.bfloat16, 0, True),
    ((192, 128), torch.float32, 0, False),
    ((160, 160), torch.bfloat16, 0, True),       # StableLM: the wide design
    ((128, 136), torch.bfloat16, 0, True),       # dv past 128: wide too
    ((160, 160), torch.float32, 0, False),       # StableLM in fp32
    ((192, 160), torch.bfloat16, 0, True),
    ((160, 160), torch.bfloat16, 1, False),
    ((128, 168), torch.bfloat16, 0, False),      # dv > 160
    ((160, 168), torch.bfloat16, 0, False),
    ((200, 128), torch.bfloat16, 0, False),      # d > 192
    ((256, 256), torch.bfloat16, 0, False)])
def test_routing_rule(shape, dtype, offset, tc):
    """``takes_tensor_cores``: bf16, d and dv multiples of 8, d <= 192,
    dv <= 160, every operand on a 16-byte boundary; anything else goes
    to the CUDA-core kernel (the rule reads shapes, dtypes and addresses
    only, so it is checked here on CPU tensors)."""
    d, dv = shape
    q = torch.zeros((1, 8, 4, d), dtype=dtype)
    k = torch.zeros((1, 8, 2, d), dtype=dtype)
    buf = torch.zeros(1 * 8 * 2 * dv + 8, dtype=dtype)
    v = buf[offset:offset + 16 * dv].view(1, 8, 2, dv)
    assert attn_kernel.takes_tensor_cores(q, k, v) == tc


@pytest.mark.parametrize("d,dv,ok", [(256, 256, True), (192, 128, True),
                                     (160, 160, True), (264, 128, False),
                                     (128, 264, False), (264, 264, False)])
def test_check_takes_heads_up_to_256(d, dv, ok):
    """The wrapper's checks accept every head width up to MAX_HEAD_DIM
    (256) and refuse wider ones before any launch; they read shapes only,
    so meta tensors stand in for a card's."""
    assert attn_kernel.MAX_HEAD_DIM == 256
    q = torch.empty((1, 8, 4, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, 2, d), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1, 8, 2, dv), dtype=torch.bfloat16, device="meta")
    if ok:
        attn_kernel._check(q, k, v)
    else:
        with pytest.raises(ValueError, match="at most 256"):
            attn_kernel._check(q, k, v)
