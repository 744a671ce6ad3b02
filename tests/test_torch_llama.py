"""The port's dense attention model (``repro_torch.models``) against the
JAX package on the CPU, at ``reduced_config("llama3.2-3b")`` (2 layers,
d_model 64, 4 heads over 2 KV heads of 16, d_ff 128, vocab 256).

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit by ``convert.params_from_jax``; inputs are
drawn with numpy from a seed. Each check runs twice:

- ``f32``: parameters and activations cast to fp32, so every cast of the
  JAX code is the identity and the two packages differ only in the order
  of fp32 sums and in ulps of fp32 ``exp``/``cos``/``sin`` — tight
  elementwise tolerances (atol 1e-5, rtol 1e-4);
- ``bf16``: as the models run. The port rounds to bf16 exactly where the
  JAX source casts; op by op (``jax.disable_jit()``) single ops agree to
  a bf16 ulp, and a flipped rounding (mostly in the MLP's output) is
  carried through the layers. A compiled JAX function lets XLA fuse the
  bf16 operations and skip intermediate roundings.

The kernel path (``use_kernel=True``: ``ops.attention``, whose plain
version on the CPU is ``attention_ref``) computes p·V in fp32 where
``blockwise_attention`` and JAX's model round p to bf16 first, so in bf16
it is held to JAX with its own, wider bounds.

bf16 tolerances are normwise — ``max |port - jax| <= frac * max |jax|``
— because a flipped bf16 rounding moves one element by an ulp of a
neighbouring intermediate, which is large relative to small elements.
Each ``frac`` is 2-4x the largest error measured over 12 seeds
(``PYTHONPATH=src python tests/test_torch_llama.py`` prints them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jinit
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}
F32_TOL = dict(atol=1e-5, rtol=1e-4)
# normwise fractions for bf16, by what is compared (see the docstring):
# measured maxima over 12 seeds in the comments
BF16_FRAC = {
    "eager": dict(logits=2e-2, cache=1e-2),          # 6.2e-3, 2.9e-3
    "kernel": dict(logits=5e-2, cache=4e-2),         # 1.6e-2, 1.2e-2
    "jit": dict(logits=4e-2, cache=3e-2),            # 1.2e-2, 7.7e-3
    "decode_eager": dict(logits=1e-6, cache=1e-6),   # 1.3e-7, 0
    "decode_jit": dict(logits=4e-2, cache=3e-2),     # 1.0e-2, 7.4e-3
}


def _close(got, want, dtype, frac=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= frac * scale, (err, scale, frac)


@pytest.fixture(scope="module")
def cfgs():
    return reduced_config(ARCH), jreduced(ARCH)


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jinit(JM.model_defs(cfgs[1]), jax.random.key(0))


def _params(jparams, dtype):
    """The same tree in both packages, cast to ``dtype``."""
    td, jd = DT[dtype]
    jp = jax.tree.map(lambda a: a.astype(jd), jparams)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return tp, jp


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return a.float().numpy()


def _both(a, dtype):
    """numpy f32 ``a`` in both packages at ``dtype`` (rounded once)."""
    j = jnp.asarray(a).astype(DT[dtype][1])
    return torch.from_numpy(_np(j)).to(DT[dtype][0]), j


def _tokens(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _layer0(tp, jp):
    return (M._index(tp["blocks"], 0)["s0"],
            jax.tree.map(lambda a: a[0], jp["blocks"]["s0"]))


def test_config_matches_jax(cfgs):
    cfg, jcfg = cfgs
    assert ARCH in ARCH_NAMES
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "rope_theta",
              "tie_embeddings", "norm_type", "act", "sliding_window",
              "qkv_bias", "num_blocks"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.padded_vocab() == jcfg.padded_vocab() == 2048
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff) == (2, 64, 4, 2, 16, 128)
    assert M.count_model_params(cfg) == JM.count_model_params(jcfg)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff,
            full.padded_vocab()) == (28, 3072, 24, 8, 128, 8192, 129024)
    assert M.count_model_params(full) == 3_215_109_120
    for batch, seq in ((2, 8), (4, 4096)):
        assert M.cache_shapes(cfg, batch, seq) == \
            JM.cache_shapes(jcfg, batch, seq)
    windowed = dataclasses.replace(cfg, sliding_window=16)
    jwindowed = dataclasses.replace(jcfg, sliding_window=16)
    assert M.cache_shapes(windowed, 2, 40) == \
        JM.cache_shapes(jwindowed, 2, 40)


def test_reduced_config_windows_as_jax():
    """A windowed config gets the JAX package's smoke window (16)."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jbase._REGISTRY["windowed-smoke-test"] = dataclasses.replace(
        jbase.get_config(ARCH), name="windowed-smoke-test",
        sliding_window=4096)
    tbase._REGISTRY["windowed-smoke-test"] = dataclasses.replace(
        get_config(ARCH), name="windowed-smoke-test", sliding_window=4096)
    try:
        assert reduced_config("windowed-smoke-test").sliding_window == \
            jreduced("windowed-smoke-test").sliding_window == 16
    finally:
        del jbase._REGISTRY["windowed-smoke-test"]
        del tbase._REGISTRY["windowed-smoke-test"]


def test_params_cross_bit_for_bit(jparams):
    tp, jp = _params(jparams, "bf16")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jl) == len(jax.tree.leaves(tp))
    for path, leaf in jl:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))
    mix = tp["blocks"]["s0"]
    assert set(mix) == {"norm1", "mixer", "norm2", "ffn"}
    assert tuple(mix["mixer"]["wq"].shape) == (2, 64, 4, 16)
    assert tuple(mix["ffn"]["wg"].shape) == (2, 64, 128)


@pytest.mark.parametrize("theta", [500_000.0, 10_000.0])
def test_rope_matches_jax(theta):
    """Angles up to 4095 rad: both packages compute the same fp32 angle
    and fp32 cos/sin differ by at most an ulp (6e-8)."""
    pos = np.arange(4096)
    ct, st = L.rope_cos_sin(torch.from_numpy(pos), 128, theta)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 128, theta)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-7,
                               rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-7,
                               rtol=0)
    x = np.random.default_rng(1).standard_normal((2, 4096, 3, 128)) \
        .astype(np.float32)
    for dtype in ("f32", "bf16"):
        xt, xj = _both(x, dtype)
        got = L.apply_rope(xt, ct, st)
        want = JL.apply_rope(xj, cj, sj)
        assert got.dtype == DT[dtype][0]
        _close(_t(got), _np(want), dtype, 1e-2)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_attention_matches_jax(dtype, window):
    """Blocks of 8 over 29 keys: the pad path; JAX op by op."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 29, 4, 16), (2, 29, 2, 16), (2, 29, 2, 16)))
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
    got = L.blockwise_attention(qt, kt, vt, causal=True, window=window,
                                block_kv=8)
    with jax.disable_jit():
        want = JL.blockwise_attention(qj, kj, vj, causal=True,
                                      window=window, block_kv=8)
    _close(_t(got), _np(want), dtype, 2e-2)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_jax(dtype, window):
    """One token against an 8-slot cache at kv_len 6; with a window the
    cache is rolled (slot i holds position pos - S + i)."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 1, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16),
                      (2, 1, 2, 16), (2, 1, 2, 16))]
    (qt, qj), (kt, kj), (vt, vj), (knt, knj), (vnt, vnj) = \
        (_both(a, dtype) for a in arrs)
    cp = None if window is None else np.arange(8) - 2
    got = L.decode_attention(qt, kt, vt, knt, vnt, kv_len=6, window=window,
                             cache_positions=None if cp is None
                             else torch.from_numpy(cp))
    with jax.disable_jit():
        want = JL.decode_attention(qj, kj, vj, knj, vnj, kv_len=6,
                                   window=window,
                                   cache_positions=None if cp is None
                                   else jnp.asarray(cp))
    _close(_t(got), _np(want), dtype, 2e-2)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_self_attention_matches_jax(cfgs, jparams, dtype, use_kernel):
    """JAX's ``self_attention`` runs ``blockwise_attention``; the port's
    kernel call site (its plain version here) must give the same
    function, p·V in fp32 where JAX rounds p to bf16."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    lt, lj = _layer0(tp, jp)
    x = np.random.default_rng(5).standard_normal((2, 21, 64)) \
        .astype(np.float32)
    xt, xj = _both(x, dtype)
    before = attn_kernel.flash_attention.launches
    out, (k, v) = L.self_attention(cfg, lt["mixer"], xt, torch.arange(21),
                                   use_kernel=use_kernel)
    assert attn_kernel.flash_attention.launches == before
    with jax.disable_jit():
        oj, (kj, vj) = JL.self_attention(jcfg, lj["mixer"], xj,
                                         jnp.arange(21))
    assert out.dtype == DT[dtype][0] and out.shape == oj.shape
    frac = BF16_FRAC["kernel" if use_kernel else "eager"]["cache"]
    _close(_t(out), _np(oj), dtype, frac)
    _close(_t(k), _np(kj), dtype, frac)
    _close(_t(v), _np(vj), dtype, frac)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("start", [0, 37])
def test_self_attention_kernel_path_offset_positions(cfgs, jparams, start,
                                                     window):
    """The kernel masks by sequence index; with consecutive positions
    from any start that is the positions' mask, so the kernel call site
    still equals JAX's ``self_attention`` (f32)."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, "f32")
    lt, lj = _layer0(tp, jp)
    x = np.random.default_rng(6).standard_normal((2, 17, 64)) \
        .astype(np.float32)
    xt, xj = _both(x, "f32")
    out, _ = L.self_attention(cfg, lt["mixer"], xt, start + torch.arange(17),
                              window=window, use_kernel=True)
    with jax.disable_jit():
        oj, _ = JL.self_attention(jcfg, lj["mixer"], xj,
                                  start + jnp.arange(17), window=window)
    _close(_t(out), _np(oj), "f32")


@pytest.mark.parametrize("positions", [[0, 1, 3, 4], [3, 2, 1, 0],
                                       [0, 0, 1, 2]])
def test_self_attention_kernel_path_needs_consecutive_positions(
        cfgs, jparams, positions):
    """Positions the kernel's index mask cannot express raise on the
    kernel path; the plain path takes them."""
    cfg, _ = cfgs
    tp, jp = _params(jparams, "f32")
    lt, _ = _layer0(tp, jp)
    x = torch.from_numpy(np.random.default_rng(7)
                         .standard_normal((1, 4, 64)).astype(np.float32))
    pos = torch.tensor(positions)
    with pytest.raises(ValueError, match="consecutive"):
        L.self_attention(cfg, lt["mixer"], x, pos, use_kernel=True)
    out, _ = L.self_attention(cfg, lt["mixer"], x, pos, use_kernel=False)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_self_attention_decode_matches_jax(cfgs, jparams, dtype):
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    lt, lj = _layer0(tp, jp)
    rng = np.random.default_rng(6)
    xt, xj = _both(rng.standard_normal((2, 1, 64)).astype(np.float32),
                   dtype)
    (kt, kj), (vt, vj) = (
        _both(rng.standard_normal((2, 8, 2, 16)).astype(np.float32), dtype)
        for _ in range(2))
    out, (kn, vn) = L.self_attention_decode(cfg, lt["mixer"], xt, 5,
                                            {"k": kt, "v": vt})
    with jax.disable_jit():
        oj, (knj, vnj) = JL.self_attention_decode(jcfg, lj["mixer"], xj, 5,
                                                  {"k": kj, "v": vj})
    frac = BF16_FRAC["eager"]["cache"]
    for a, b in ((out, oj), (kn, knj), (vn, vnj)):
        _close(_t(a), _np(b), dtype, frac)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_matches_jax(cfgs, dtype, act):
    """The gelu branch is ``jax.nn.gelu``'s default, the tanh form."""
    cfg, jcfg = (dataclasses.replace(c, act=act) for c in cfgs)
    defs = JL.mlp_defs(jcfg)
    jp = {k: v.astype(DT[dtype][1]) for k, v in
          jinit(defs, jax.random.key(2)).items()}
    if act == "gelu":   # nonzero biases
        jp["b1"] = (0.1 * jax.random.normal(jax.random.key(3), (128,))) \
            .astype(DT[dtype][1])
        jp["b2"] = (0.1 * jax.random.normal(jax.random.key(4), (64,))) \
            .astype(DT[dtype][1])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: d.shape for k, d in L.mlp_defs(cfg).items()}
    xt, xj = _both(np.random.default_rng(7).standard_normal((2, 9, 64))
                   .astype(np.float32), dtype)
    with jax.disable_jit():
        want = JL.mlp(jcfg, jp, xj)
    _close(_t(L.mlp(cfg, tp, xt)), _np(want), dtype,
           BF16_FRAC["eager"]["cache"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_forward_matches_jax(cfgs, jparams, dtype, use_kernel):
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    lt, lj = _layer0(tp, jp)
    xt, xj = _both(np.random.default_rng(8).standard_normal((2, 13, 64))
                   .astype(np.float32), dtype)
    out, cache, _ = M.layer_forward(cfg, lt, xt, 0, use_kernel=use_kernel)
    with jax.disable_jit():
        oj, cj, _ = JM.layer_forward(jcfg, lj, xj, 0,
                                     positions=jnp.arange(13),
                                     mode="prefill")
    frac = BF16_FRAC["kernel" if use_kernel else "eager"]["cache"]
    _close(_t(out), _np(oj), dtype, frac)
    for k in ("k", "v"):
        _close(_t(cache[k]), _np(cj[k]), dtype, frac)


def test_sliding_window_layer_trims_the_cache(cfgs, jparams):
    """With a window of 8, a 13-token prefill keeps the last 8 keys, and
    attention masks as JAX's does."""
    cfg, jcfg = (dataclasses.replace(c, sliding_window=8) for c in cfgs)
    tp, jp = _params(jparams, "f32")
    lt, lj = _layer0(tp, jp)
    xt, xj = _both(np.random.default_rng(9).standard_normal((2, 13, 64))
                   .astype(np.float32), "f32")
    with jax.disable_jit():
        oj, cj, _ = JM.layer_forward(jcfg, lj, xj, 0,
                                     positions=jnp.arange(13),
                                     mode="prefill")
    for use_kernel in (False, True):
        out, cache, _ = M.layer_forward(cfg, lt, xt, 0,
                                        use_kernel=use_kernel)
        assert tuple(cache["k"].shape) == (2, 8, 2, 16)
        _close(_t(out), _np(oj), "f32")
        _close(_t(cache["k"]), _np(cj["k"]), "f32")


def _run_jax(mode, fn, *args):
    if mode == "eager":
        with jax.disable_jit():
            return fn(*args)
    return fn(*args)


def _caches_close(ct, cj, dtype, frac):
    for k in ("k", "v"):
        _close(_t(ct["blocks"]["s0"][k]), _np(cj["blocks"]["s0"][k]), dtype,
               frac)


@pytest.mark.parametrize("mode,use_kernel", [("eager", None),
                                             ("eager", True),
                                             ("jit", None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_prefill_matches_jax(cfgs, jparams, dtype, mode,
                                     use_kernel):
    """Against JAX op by op (``eager``) and compiled (``jit``, as the JAX
    package runs it); ``use_kernel=True`` is the port's attention kernel
    call site (its plain version on the CPU) against JAX's
    ``blockwise_attention``."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    tok = _tokens(2, 29, 4, cfg.vocab_size)
    before = attn_kernel.flash_attention.launches
    logits, caches = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                                       use_kernel=use_kernel)
    assert attn_kernel.flash_attention.launches == before
    lj, cj = _run_jax(mode, lambda: JM.forward_prefill(jcfg, jp,
                                                      jnp.asarray(tok)))
    V = cfg.vocab_size
    assert logits.shape == lj.shape == (2, cfg.padded_vocab())
    assert (logits[:, V:] == -1e9).all()
    frac = BF16_FRAC["kernel" if use_kernel else mode]
    _close(_t(logits)[:, :V], _np(lj)[:, :V], dtype, frac["logits"])
    assert caches["prefix"] == {} and set(caches["blocks"]) == {"s0"}
    for k, shape in M.cache_shapes(cfg, 2, 29)["blocks"]["s0"].items():
        assert tuple(caches["blocks"]["s0"][k].shape) == shape
        assert caches["blocks"]["s0"][k].dtype == DT[dtype][0]
    _caches_close(caches, cj, dtype, frac["cache"])


@pytest.mark.parametrize("mode", ["eager", "jit"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_decode_matches_jax(cfgs, jparams, dtype, mode):
    """One decode step from the JAX prefill's caches, carried across."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    tok = _tokens(2, 16, 5, cfg.vocab_size)
    nxt = _tokens(2, 1, 6, cfg.vocab_size)

    def jax_side():
        _, cj = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
        return cj, JM.forward_decode(jcfg, jp, jnp.asarray(nxt), 16, cj)

    cj, (lj, nj) = _run_jax(mode, jax_side)
    ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    logits, new = M.forward_decode(cfg, tp, torch.from_numpy(nxt), 16, ct)
    V = cfg.vocab_size
    frac = BF16_FRAC[f"decode_{mode}"]
    _close(_t(logits)[:, :V], _np(lj)[:, :V], dtype, frac["logits"])
    for k, shape in M.cache_shapes(cfg, 2, 1)["blocks"]["s0"].items():
        assert tuple(new["blocks"]["s0"][k].shape) == shape
    _caches_close(new, nj, dtype, frac["cache"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_decode_equals_prefill(cfgs, jparams, dtype,
                                            use_kernel):
    """prefill(S-1) + decode at position S-1 == prefill(S)'s last logits.
    The cached k/v are those the S-token prefill computes; in bf16 the
    decode step rounds p to bf16 once over the whole cache, where the
    prefill does per block (or, on the kernel path, not at all): 3% of the
    largest logit (measured 0.9% over 12 seeds)."""
    cfg = cfgs[0]
    tp, _ = _params(jparams, dtype)
    tok = torch.from_numpy(_tokens(2, 24, 7, cfg.vocab_size))
    full, caches_full = M.forward_prefill(cfg, tp, tok,
                                          use_kernel=use_kernel)
    _, caches = M.forward_prefill(cfg, tp, tok[:, :-1],
                                  use_kernel=use_kernel)
    step, delta = M.forward_decode(cfg, tp, tok[:, -1:], 23, caches)
    V = cfg.vocab_size
    _close(_t(step)[:, :V], _t(full)[:, :V], dtype, 3e-2)
    _close(_t(delta["blocks"]["s0"]["k"]),
           _t(caches_full["blocks"]["s0"]["k"][:, :, -1:]), dtype, 3e-2)


@pytest.mark.parametrize("change, what", [
    (dict(cross_attn_period=2, num_image_tokens=16), "cross"),
    (dict(is_encoder_decoder=True, encoder_layers=2), "encoder"),
])
def test_cross_and_encoder_layers_build(cfgs, change, what):
    """Llama with cross-attention layers, or made an encoder-decoder,
    builds JAX's parameter tree (keys and shapes) and JAX's cache
    shapes: the image K/V in a cross layer, the encoder's xk/xv in every
    layer of an encoder-decoder."""
    cfg = dataclasses.replace(cfgs[0], **change)
    jcfg = dataclasses.replace(cfgs[1], **change)
    assert jax.tree.map(lambda d: d.shape, JM.model_defs(jcfg)) == \
        jax.tree.map(lambda d: d.shape, M.model_defs(cfg),
                     is_leaf=lambda d: not isinstance(d, dict))
    shapes = M.cache_shapes(cfg, 2, 8)
    assert shapes == JM.cache_shapes(jcfg, 2, 8)
    s0 = shapes["blocks"]["s0"]
    if what == "cross":
        assert s0 == {"k": (2, 2, 16, 2, 16), "v": (2, 2, 16, 2, 16)}
    else:
        assert s0["xk"] == (2, 2, cfg.encoder_seq, 2, 16)
        assert "encoder" in M.model_defs(cfg)


# ------------------------------------------------- how the bounds were set --

def _measure_jax_parity(seeds=range(12)):
    """Largest normwise bf16 error of the port against JAX per BF16_FRAC
    entry (and of prefill(S-1) + decode against prefill(S)) over
    ``seeds``: each seed draws its own JAX parameters and tokens."""
    cfg, jcfg = reduced_config(ARCH), jreduced(ARCH)
    V = cfg.vocab_size
    worst = {}

    def note(key, what, got, want):
        got = np.asarray(got, np.float32)
        want = np.asarray(want, np.float32)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        worst.setdefault(key, {}).setdefault(what, 0.0)
        worst[key][what] = max(worst[key][what], err)

    prefill = jax.jit(lambda p, t: JM.forward_prefill(jcfg, p, t))
    decode = jax.jit(lambda p, t, c: JM.forward_decode(jcfg, p, t, 29, c))
    for seed in seeds:
        tp, jp = _params(jinit(JM.model_defs(jcfg), jax.random.key(seed)),
                         "bf16")
        tok = _tokens(2, 29, 100 + seed, V)
        nxt = _tokens(2, 1, 200 + seed, V)
        with jax.disable_jit():
            je = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
            jde = JM.forward_decode(jcfg, jp, jnp.asarray(nxt), 29, je[1])
        jj = prefill(jp, jnp.asarray(tok))
        jdj = decode(jp, jnp.asarray(nxt), jj[1])
        for use_kernel, modes in ((None, (("eager", je), ("jit", jj))),
                                  (True, (("kernel", je), ("kernel", jj)))):
            lt, ct = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                                       use_kernel=use_kernel)
            for key, (lj, cj) in modes:
                note(key, "logits", _t(lt)[:, :V], _np(lj)[:, :V])
                for k in ("k", "v"):
                    note(key, "cache", _t(ct["blocks"]["s0"][k]),
                         _np(cj["blocks"]["s0"][k]))
        for key, (_, cj), (lj, nj) in (("decode_eager", je, jde),
                                       ("decode_jit", jj, jdj)):
            ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
            lt, nt = M.forward_decode(cfg, tp, torch.from_numpy(nxt), 29, ct)
            note(key, "logits", _t(lt)[:, :V], _np(lj)[:, :V])
            for k in ("k", "v"):
                note(key, "cache", _t(nt["blocks"]["s0"][k]),
                     _np(nj["blocks"]["s0"][k]))
        t = torch.from_numpy(tok)
        full, _ = M.forward_prefill(cfg, tp, t)
        _, caches = M.forward_prefill(cfg, tp, t[:, :-1])
        step, _ = M.forward_decode(cfg, tp, t[:, -1:], 28, caches)
        note("prefill_then_decode", "logits", _t(step)[:, :V],
             _t(full)[:, :V])
    return worst


def _measure_kernel_path(seeds=range(3)):
    """Relative RMS error of the kernel path (``use_kernel=True``: its
    plain version here) against ``blockwise_attention``, as
    ``chip_smoke.py`` phase 8 measures it on the card: attention outputs
    layer by layer on the same inputs, one decode step on the first S-1
    keys against the prefill's last row, last-token logits end to end,
    and prefill(S-1) + decode against prefill(S) — at the reduced config
    (S 64) and at 28 layers of d_model 256 (3 heads over 1 KV head of
    128, d_ff 512, vocab 4096, S 512)."""
    from repro_torch.models.params import init_params

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    deep = dataclasses.replace(get_config(ARCH), d_model=256, num_heads=3,
                               num_kv_heads=1, d_ff=512, vocab_size=4096)
    out = {}
    for name, cfg, S in (("reduced", reduced_config(ARCH), 64),
                         ("28 layers, d_model 256", deep, 512)):
        w = dict(layer=0.0, decode_layer=0.0, logits=0.0, decode_logits=0.0)
        V = cfg.vocab_size
        pos = torch.arange(S)
        for seed in seeds:
            p = init_params(M.model_defs(cfg),
                            torch.Generator().manual_seed(seed), "cpu")
            tok = torch.randint(0, V, (2, S), generator=torch.Generator()
                                .manual_seed(50 + seed))
            lk, _ = M.forward_prefill(cfg, p, tok, use_kernel=True)
            lp, _ = M.forward_prefill(cfg, p, tok, use_kernel=False)
            w["logits"] = max(w["logits"], rel(lk[:, :V], lp[:, :V]))
            _, c = M.forward_prefill(cfg, p, tok[:, :-1], use_kernel=True)
            st, _ = M.forward_decode(cfg, p, tok[:, -1:], S - 1, c)
            w["decode_logits"] = max(w["decode_logits"],
                                     rel(st[:, :V], lk[:, :V]))
            x = M._embed(cfg, p, tok)
            for l in range(cfg.num_layers):
                lp_ = M._index(p["blocks"], l)["s0"]
                h = L.apply_norm(cfg, lp_["norm1"], x)
                yk, (k, v) = L.self_attention(cfg, lp_["mixer"], h, pos,
                                              use_kernel=True)
                yp, _ = L.self_attention(cfg, lp_["mixer"], h, pos,
                                         use_kernel=False)
                w["layer"] = max(w["layer"], rel(yk, yp))
                yd, _ = L.self_attention_decode(
                    cfg, lp_["mixer"], h[:, -1:], S - 1,
                    {"k": k[:, :-1], "v": v[:, :-1]})
                w["decode_layer"] = max(w["decode_layer"],
                                        rel(yd, yk[:, -1:]))
                x, _ = M._ffn(cfg, lp_, x + yk)
        out[name] = w
    return out


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_llama.py: the measurements
    # behind BF16_FRAC here and chip_smoke.py's LLAMA_TOL
    torch.set_num_threads(8)
    for key, errs in _measure_jax_parity().items():
        print("port vs JAX, bf16, normwise:", key, errs)
    for name, errs in _measure_kernel_path().items():
        print("kernel path vs blockwise_attention, rel RMS:", name, errs)
