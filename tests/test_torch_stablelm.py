"""StableLM-12B in the port against the JAX package on the CPU, at its
real head width, and the tensor-core attention kernel's wide design
(``csrc/attention.cu``: dv above 128) modelled at that width.

The model: ``get_config("stablelm-12b")`` with ``head_dim`` 160 kept and
the rest narrowed — 2 layers, d_model 640, 4 heads over 1 KV head, d_ff
256, vocab 512 (``_narrow``, built alike in both packages). Its weights
are drawn with numpy from a seed, as the JAX package's ``init_params``
distributes them, and carried across bit for bit by
``convert.params_from_jax``; tokens are drawn with numpy too. Each model
check runs twice:

- ``f32``: weights and activations in fp32, so the two packages differ
  only in the order of fp32 sums and in ulps of ``exp``/``cos``/``sin``:
  elementwise within ``F32_TOL``;
- ``bf16``: as the model runs, against JAX op by op
  (``jax.disable_jit()``): normwise, ``max |port - jax| <= frac * max
  |jax|`` with ``frac`` from ``BF16_FRAC``, each 2-4x the largest error
  measured over 8 seeds (``PYTHONPATH=src python
  tests/test_torch_stablelm.py`` prints them).

The kernel path (``use_kernel=True``: ``ops.attention``, whose plain
version on the CPU is ``attention_ref``) computes p·V in fp32 where JAX's
``blockwise_attention`` rounds p to bf16, so in bf16 it has its own,
wider bounds. The same script measures the kernel path against
``blockwise_attention`` at StableLM's full depth, which sets
``chip_smoke.py``'s ``STABLELM_TOL``.

The wide design's index arithmetic — its choice of k16 steps, the
shared-memory layout TMA writes and the wgmma descriptors read, the
accumulator and A-fragment maps at n = 112 and n = 160, the epilogue's
columns — is emulated byte by byte in numpy and must reproduce q·kᵀ and
p_hi·V + p_lo·V of a tile exactly; ``test_torch_cuda.py`` holds the CUDA
kernel itself to ``attention_ref`` on a card.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.attention.ops import attention as jattention
from repro.kernels.attention.ref import attention_ref as jattention_ref
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models.params import is_def as jis_def
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attention import kernel as attn_kernel, ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.models import model as M
from test_torch_attention import _both as _attn_both, _close as _attn_close
from test_torch_attention import _tc_model
from test_torch_cuda import _attn_inputs

torch.set_num_threads(1)

ARCH = "stablelm-12b"
NARROW = dict(num_layers=2, d_model=640, num_heads=4, num_kv_heads=1,
              d_ff=256, vocab_size=512)
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = dict(atol=2e-5, rtol=2e-4)
# normwise fractions for bf16; the largest errors measured over 8 seeds
# in the comments
BF16_FRAC = {
    "eager": dict(logits=3e-2, cache=2e-2),     # 8.1e-3, 6.0e-3
    "kernel": dict(logits=4e-2, cache=3e-2),    # 1.0e-2, 8.2e-3
    "decode": dict(logits=2e-2, cache=2e-2),    # 5.4e-3, 5.2e-3
}


def _narrow(get):
    return dataclasses.replace(get(ARCH), name=ARCH + "-narrow", **NARROW)


@pytest.fixture(scope="module")
def cfgs():
    return _narrow(get_config), _narrow(jget_config)


def _np_params(jcfg, seed):
    """The JAX package's parameter tree for ``jcfg``, every leaf drawn
    with numpy from ``seed`` as ``init_params`` distributes it (zeros,
    ones, normal 0.02 scale, or scale / sqrt(fan_in)), in fp32."""
    defs = JM.model_defs(jcfg)
    leaves, treedef = jax.tree.flatten(defs, is_leaf=jis_def)
    rng = np.random.default_rng(seed)

    def make(d):
        if d.init in ("zeros", "ones"):
            return np.full(d.shape, float(d.init == "ones"), np.float32)
        if d.init == "scaled":
            fan = d.fan_in if d.fan_in is not None else (
                d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
            std = d.scale / math.sqrt(max(fan, 1))
        else:
            std = 0.02 * d.scale
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    return jax.tree.unflatten(treedef, [make(d) for d in leaves])


def _params(jcfg, dtype, seed=0):
    """The same tree in both packages at ``dtype`` (rounded once, by
    JAX, then carried across bit for bit)."""
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(DT[dtype][1]),
                      _np_params(jcfg, seed))
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp


def _tokens(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _f(a):
    """A torch tensor or a JAX array as numpy fp32."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _err(got, want):
    got, want = _f(got), _f(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _close(got, want, dtype, frac):
    if dtype == "f32":
        np.testing.assert_allclose(_f(got), _f(want), **F32_TOL)
    else:
        err = _err(got, want)
        assert err <= frac, (err, frac)


def _kv(caches):
    return [caches["blocks"]["s0"][k] for k in ("k", "v")]


def test_config_matches_jax(cfgs):
    """The narrowed config keeps StableLM's head width and topology, in
    both packages; the full one is StableLM-2-12B's."""
    cfg, jcfg = cfgs
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta",
              "tie_embeddings", "norm_type", "act", "sliding_window",
              "qkv_bias", "num_blocks"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.head_dim == 160
    assert M.count_model_params(cfg) == JM.count_model_params(jcfg)
    assert M.cache_shapes(cfg, 2, 29) == JM.cache_shapes(jcfg, 2, 29)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size) == (40, 5120, 32, 8, 160, 13824, 100352)
    assert M.count_model_params(full) == \
        JM.count_model_params(jget_config(ARCH))


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_prefill_matches_jax(cfgs, dtype, use_kernel):
    """Last-position logits and both layers' k/v caches of a 2 x 29
    prefill against JAX op by op; ``use_kernel=True`` is the kernel's
    call site (its plain version here), no launch counted."""
    cfg, jcfg = cfgs
    tp, jp = _params(jcfg, dtype)
    tok = _tokens(2, 29, 4, cfg.vocab_size)
    before = attn_kernel.flash_attention.launches
    logits, caches = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                                       use_kernel=use_kernel)
    assert attn_kernel.flash_attention.launches == before
    with jax.disable_jit():
        lj, cj = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
    V = cfg.vocab_size
    assert logits.shape == lj.shape == (2, cfg.padded_vocab())
    assert bool((logits[:, V:] == -1e9).all())
    frac = BF16_FRAC["kernel" if use_kernel else "eager"]
    _close(logits[:, :V], lj[:, :V], dtype, frac["logits"])
    for got, want in zip(_kv(caches), _kv(cj)):
        assert got.dtype == DT[dtype][0]
        assert tuple(got.shape) == want.shape == (2, 2, 29, 1, 160)
        _close(got, want, dtype, frac["cache"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_decode_steps_match_jax(cfgs, dtype):
    """Two ``forward_decode`` steps after a 2 x 16 prefill: the first
    from JAX's prefill caches carried across, the second from each
    package's own caches with its first step's k/v appended."""
    cfg, jcfg = cfgs
    tp, jp = _params(jcfg, dtype)
    tok = _tokens(2, 16, 5, cfg.vocab_size)
    nxt = [_tokens(2, 1, 6 + i, cfg.vocab_size) for i in range(2)]
    with jax.disable_jit():
        _, cj = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
    ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    V = cfg.vocab_size
    frac = BF16_FRAC["decode"]
    for i, t in enumerate(nxt):
        pos = 16 + i
        lt, dt = M.forward_decode(cfg, tp, torch.from_numpy(t), pos, ct)
        with jax.disable_jit():
            lj, dj = JM.forward_decode(jcfg, jp, jnp.asarray(t), pos, cj)
        _close(lt[:, :V], lj[:, :V], dtype, frac["logits"])
        for got, want in zip(_kv(dt), _kv(dj)):
            _close(got, want, dtype, frac["cache"])
        ct = {"prefix": {}, "blocks": {"s0": {
            k: torch.cat([ct["blocks"]["s0"][k], dt["blocks"]["s0"][k]], 2)
            for k in ("k", "v")}}}
        cj = {"prefix": {}, "blocks": {"s0": {
            k: jnp.concatenate([cj["blocks"]["s0"][k],
                                dj["blocks"]["s0"][k]], 2)
            for k in ("k", "v")}}}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 20)])
def test_attention_at_head_width_160_matches_jax_kernel(dtype, causal,
                                                        window):
    """The kernel's call site at d = dv = 160, 4 heads over 1 (plain on
    the CPU, its pad path included) against JAX's ``attention`` running
    the Pallas kernel in interpret mode."""
    t, j = _attn_both(_attn_inputs(1, 40, 40, 4, 1, 160, 8), dtype)
    got = ops.attention(*t, causal=causal, window=window, block_q=16,
                        block_kv=16)
    assert got.shape == (1, 40, 4, 160)
    _attn_close(got, jattention(*j, causal=causal, window=window,
                                block_q=16, block_kv=16, interpret=True),
                dtype)


def test_serve_matches_jax():
    """The StableLM smoke serve gives the JAX package's statistics, the
    committed ones ``chip_smoke.py`` phase 15 holds the full-width serve
    to (``STABLELM_SERVE_ARGV``: ``STABLELM_SERVE_EXPECTED``)."""
    from test_torch_cuda import _chip_smoke
    smoke = _chip_smoke()
    argv = ["--arch", ARCH, "--smoke"] + smoke.STABLELM_SERVE_ARGV
    got = serve.main(argv + ["--device", "cpu"])
    want = jserve.main(argv)
    stats = [{k: r[k] for k in smoke.STABLELM_SERVE_EXPECTED}
             for r in (got, want)]
    assert stats[0] == stats[1] == smoke.STABLELM_SERVE_EXPECTED


# ------------------- the wide design's index arithmetic, emulated ----

ROW = 128                # bytes of a swizzled row: 64 bf16 columns
TILE = 128 * ROW         # one 128-row q panel
SMEM_LIMIT = 227 * 1024  # shared memory one block may take


def _tc_design(d, dv):
    """(k16 steps of q.k, columns of p.V, keys a tile) as
    ``attention_tc_launch`` picks its instantiation: the narrow design
    up to dv 128, the wide one above."""
    if dv > 128:
        return (12 if d > 160 else 10 if d > 128 else 8), 160, 112
    return 4 * -(-d // 64), 64 * -(-dv // 64), 128


def _layout(ks, nv, bk):
    """Byte offsets (from the 1024-aligned base) of the q tile, the two
    K and V stages and the barriers, as the kernel lays them out, and
    the dynamic shared memory it asks for."""
    dp, dvp, kvp = -(-ks // 4), -(-nv // 64), bk * ROW
    sK = dp * TILE
    sV = sK + 2 * dp * kvp
    bars = sV + 2 * dvp * kvp
    return dict(sQ=0, sK=sK, sV=sV, kvp=kvp, dp=dp, dvp=dvp,
                smem=1024 + bars + 8 * (1 + 3 * 2))


def _swz(addr):
    """The 128-byte swizzle: 16-byte chunk c of row r at c ^ (r % 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma(mem, base, x, panel_bytes):
    """TMA's write of tile ``x`` (rows x cols, zero past its columns) as
    64-column panels ``panel_bytes`` apart from ``base``."""
    rows, cols = x.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    addr = base + (c // 64) * panel_bytes + r * ROW + 2 * (c % 64)
    mem[_swz(addr) // 2] = x


def _read_k_major(mem, start, rows):
    """A K-major operand (rows x 16) under a 128B-swizzle descriptor at
    ``start`` with sbo 1024: (r, k) at start + (r / 8) 1024 + (r % 8) 128
    + 2 k, swizzled."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return mem[_swz(start + (r // 8) * 1024 + (r % 8) * ROW + 2 * k) // 2]


def _read_mn_major(mem, start, n, lbo):
    """An MN-major B operand (16 x n) under a 128B-swizzle descriptor at
    ``start`` with panels ``lbo`` apart and sbo 1024: (k, j) at start +
    (j / 64) lbo + (k / 8) 1024 + (k % 8) 128 + 2 (j % 64), swizzled."""
    k, j = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    return mem[_swz(start + (j // 64) * lbo + (k // 8) * 1024
                    + (k % 8) * ROW + 2 * (j % 64)) // 2]


def _acc_map(n):
    """The m64nNk16 accumulator layout: for each of a warpgroup's 128
    threads and its n / 2 registers j, the (row, column) it holds — row
    16 w + g + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 tq + (j & 1) for
    thread 32 w + 4 g + tq."""
    t = np.arange(128)[:, None]
    j = np.arange(n // 2)[None, :]
    w, g, tq = t // 32, (t % 32) // 4, t % 4
    return (16 * w + g + 8 * ((j >> 1) & 1),
            8 * (j >> 2) + 2 * tq + (j & 1))


def _bf16(x):
    return torch.from_numpy(x).float().bfloat16().double().numpy()


@pytest.mark.parametrize("d,dv", [(160, 160), (136, 136), (192, 160),
                                  (128, 144), (64, 160)])
def test_wide_design_k_steps_and_shared_memory(d, dv):
    """The wide design's instantiation for (d, dv): q.k over k16 steps
    that cover d (exactly ceil(d / 16) = 10 at StableLM's 160, so no
    zero-filled half panel is multiplied), q/k and v panels that hold d
    and dv, 112-key tiles in a TMA box (<= 256 rows), every panel and
    stage 1024-byte aligned (the swizzle's base offset 0), and the whole
    layout within a block's 227 KB — where the narrow design's 128-key
    tiles at three v panels would not fit."""
    ks, nv, bk = _tc_design(d, dv)
    lay = _layout(ks, nv, bk)
    assert bk == 112 and nv == 160 and dv <= nv and nv % 8 == 0
    assert 16 * ks >= d and 64 * lay["dp"] >= 16 * ks and lay["dp"] <= 3
    if d == 160:
        assert ks == 10
    if 128 < d <= 160:
        assert 16 * ks - d < 32
    assert all(x % 1024 == 0 for x in (lay["sK"], lay["sV"], lay["kvp"]))
    assert lay["smem"] <= SMEM_LIMIT
    assert _layout(12, 192, 128)["smem"] > SMEM_LIMIT
    for dd, dvv in ((64, 64), (128, 128), (192, 128), (192, 64)):
        assert _layout(*_tc_design(dd, dvv))["smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("d,dv", [(160, 160), (136, 144), (64, 160),
                                  (192, 128), (128, 128)])
def test_tc_addressing_reproduces_a_tiles_products(d, dv):
    """One key tile of stage 1, byte by byte: TMA's swizzled panels, the
    q.k descriptors of every k step (both consumer warpgroups), the
    accumulator map of S (n = BK) taken as the A fragments of p_hi and
    p_lo, the p.V descriptors (n = NV, panels KVP apart) and the
    epilogue's columns give Q Kᵀ and p_hi V + p_lo V exactly."""
    ks, nv, bk = _tc_design(d, dv)
    lay = _layout(ks, nv, bk)
    rng = np.random.default_rng(d + dv)
    q = _bf16(rng.standard_normal((128, d)))
    k = _bf16(rng.standard_normal((bk, d)))
    v = _bf16(rng.standard_normal((bk, dv)))
    mem = np.zeros(lay["smem"] // 2)
    stage = 1
    sk = lay["sK"] + stage * lay["dp"] * lay["kvp"]
    vs = lay["sV"] + stage * lay["dvp"] * lay["kvp"]
    _tma(mem, lay["sQ"], q, TILE)
    _tma(mem, sk, k, lay["kvp"])
    _tma(mem, vs, v, lay["kvp"])
    rows_s, cols_s = _acc_map(bk)
    rows_o, cols_o = _acc_map(nv)
    vpad = np.zeros((bk, nv))
    vpad[:, :dv] = v
    for c in (0, 1):
        s = sum(_read_k_major(mem, lay["sQ"] + (kk >> 2) * TILE
                              + c * 64 * ROW + (kk & 3) * 32, 64)
                @ _read_k_major(mem, sk + (kk >> 2) * lay["kvp"]
                                + (kk & 3) * 32, bk).T
                for kk in range(ks))
        np.testing.assert_array_equal(s, q[64 * c:64 * c + 64] @ k.T)
        # S's registers, each thread's, hold p; step kk's A fragment
        # register q packs accumulator registers 8 kk + 2 q and + 1:
        # (row g + 8 (q & 1), columns 16 kk + 8 (q >> 1) + 2 tq + 0/1)
        p = rng.random((64, bk))
        hi = _bf16(p)
        lo = _bf16(p - hi)
        o = np.zeros((64, nv))
        for part in (hi, lo):
            regs = part[rows_s, cols_s]                 # (128, bk / 2)
            for kk in range(bk // 16):
                a = np.full((64, 16), np.nan)
                for qr in range(4):
                    for e in range(2):
                        j = 8 * kk + 2 * qr + e
                        t = np.arange(128)
                        row = 16 * (t // 32) + (t % 32) // 4 + 8 * (qr & 1)
                        col = 8 * (qr >> 1) + 2 * (t % 4) + e
                        assert (rows_s[:, j] == row).all()
                        assert (cols_s[:, j] == 16 * kk + col).all()
                        a[row, col] = regs[:, j]
                assert not np.isnan(a).any()
                o += a @ _read_mn_major(mem, vs + kk * 16 * ROW, nv,
                                        lay["kvp"])
        np.testing.assert_allclose(o, (hi + lo) @ vpad, rtol=1e-13,
                                   atol=1e-13)
        # the epilogue: register 4 n8 + 2 r (+ 1) is row g + 8 r, columns
        # 8 n8 + 2 tq (+ 1); every (row, column < dv) written once
        out = np.zeros((64, nv))
        hits = np.zeros((64, nv), int)
        regs = o[rows_o, cols_o]
        for r in range(2):
            for n8 in range(nv // 8):
                t = np.arange(128)
                row = 16 * (t // 32) + (t % 32) // 4 + 8 * r
                for e in range(2):
                    col = 8 * n8 + 2 * (t % 4) + e
                    keep = col < dv
                    out[row[keep], col[keep]] = regs[keep, 4 * n8 + 2 * r + e]
                    hits[row[keep], col[keep]] += 1
        assert (hits[:, :dv] == 1).all() and (hits[:, dv:] == 0).all()
        np.testing.assert_array_equal(out[:, :dv], o[:, :dv])


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, None, None), (False, None, 150), (True, 40, None),
    (True, 2, 8), (True, None, 37), (False, 100, None)])
def test_wide_tile_range_matches_the_oracle(causal, window, kv_len):
    """The kernel's arithmetic over 112-key tiles under 128-row q blocks
    (``_tc_model`` with ``block_k=112``) at d = dv = 160 and GQA 4: the
    tiles up to the last valid key, from the first under a window, or
    every tile when a row has no valid key, give ``attention_ref``'s
    function and JAX's."""
    t, j = _attn_both(_attn_inputs(1, 300, 300, 4, 1, 160, 17), "f32")
    got = _tc_model(*t, causal=causal, window=window, kv_len=kv_len,
                    block_k=112)
    _attn_close(got, jattention_ref(*j, causal=causal, window=window,
                                    kv_len=kv_len), "f32")
    torch.testing.assert_close(
        got, attention_ref(*t, causal=causal, window=window, kv_len=kv_len),
        atol=2e-5, rtol=2e-5)


# ------------------------------------------------- how the bounds were set --

def _measure_jax_parity(seeds=range(8)):
    """Largest normwise bf16 error of the port against JAX op by op, per
    ``BF16_FRAC`` entry, over ``seeds`` (each its own weights and
    tokens)."""
    cfg, jcfg = _narrow(get_config), _narrow(jget_config)
    V = cfg.vocab_size
    worst = {}

    def note(key, what, got, want):
        worst.setdefault(key, {}).setdefault(what, 0.0)
        worst[key][what] = max(worst[key][what], _err(got, want))

    for seed in seeds:
        tp, jp = _params(jcfg, "bf16", seed)
        tok = _tokens(2, 29, 100 + seed, V)
        with jax.disable_jit():
            lj, cj = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
        for key, use_kernel in (("eager", None), ("kernel", True)):
            lt, ct = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                                       use_kernel=use_kernel)
            note(key, "logits", lt[:, :V], lj[:, :V])
            for a, b in zip(_kv(ct), _kv(cj)):
                note(key, "cache", a, b)
        ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
        nxt = _tokens(2, 1, 200 + seed, V)
        lt, dt = M.forward_decode(cfg, tp, torch.from_numpy(nxt), 29, ct)
        with jax.disable_jit():
            lj, dj = JM.forward_decode(jcfg, jp, jnp.asarray(nxt), 29, cj)
        note("decode", "logits", lt[:, :V], lj[:, :V])
        for a, b in zip(_kv(dt), _kv(dj)):
            note("decode", "cache", a, b)
    return worst


def _measure_kernel_path(seeds=range(2), S=512):
    """Relative RMS error of the kernel path (its plain version here)
    against ``blockwise_attention`` in bf16, as ``chip_smoke.py`` phase
    15 measures it on the card: last-position logits and every layer's
    k/v cache of a 2 x S prefill, at StableLM's depth (40 layers) and
    head width (160) with 4 heads over 1, d_model 640, d_ff 1024, vocab
    4096."""
    from repro_torch.models.params import init_params

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    cfg = dataclasses.replace(get_config(ARCH), d_model=640, num_heads=4,
                              num_kv_heads=1, d_ff=1024, vocab_size=4096)
    V = cfg.vocab_size
    w = dict(logits=0.0, cache=0.0)
    for seed in seeds:
        p = init_params(M.model_defs(cfg),
                        torch.Generator().manual_seed(seed), "cpu")
        tok = torch.randint(0, V, (2, S), generator=torch.Generator()
                            .manual_seed(50 + seed))
        lk, ck = M.forward_prefill(cfg, p, tok, use_kernel=True)
        lp, cp = M.forward_prefill(cfg, p, tok, use_kernel=False)
        w["logits"] = max(w["logits"], rel(lk[:, :V], lp[:, :V]))
        w["cache"] = max(w["cache"], *(rel(a, b) for a, b in
                                       zip(_kv(ck), _kv(cp))))
    return w


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_stablelm.py: the measurements
    # behind BF16_FRAC here and chip_smoke.py's STABLELM_TOL
    torch.set_num_threads(8)
    for key, errs in _measure_jax_parity().items():
        print("port vs JAX, bf16, normwise:", key, errs)
    print("kernel path vs blockwise_attention, rel RMS, 40 layers:",
          _measure_kernel_path())
