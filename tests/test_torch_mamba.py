"""The port's Mamba2 model (``repro_torch.models``) against the JAX
package on the CPU, at ``reduced_config("mamba2-130m")`` (2 layers,
d_model 64, N 16, P 8, chunk 8).

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit by ``convert.params_from_jax``; inputs are
drawn with numpy from a seed. Each check runs twice:

- ``f32``: parameters and activations cast to fp32, so every cast of the
  JAX code is the identity and the two packages differ only in the order
  of fp32 sums — tight elementwise tolerances (atol 1e-5, rtol 1e-4);
- ``bf16``: as the models run. The port rounds to bf16 exactly where the
  JAX source casts, which is what JAX computes op by op: against JAX
  with ``jax.disable_jit()`` the logits agree to ~1e-5 and the bf16
  caches to a few flipped ulps. A compiled JAX function (``lax.scan``
  compiles ``forward_prefill``) lets XLA fuse the bf16 operations and
  skip intermediate roundings, so against it the port differs as much as
  JAX's own eager and compiled runs differ (~2% of the largest value).

bf16 tolerances are normwise — ``max |port - jax| <= frac * max |jax|``
— because a flipped bf16 rounding moves one element by an ulp of a
neighbouring intermediate, which is large relative to small elements.
Each ``frac`` is 2-4x the largest error measured over 12 seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.kernels.ssd import ops as jssd_ops
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.params import init_params

torch.set_num_threads(1)

ARCH = "mamba2-130m"
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}
F32_TOL = dict(atol=1e-5, rtol=1e-4)
# normwise fractions for bf16, by what is compared (see the docstring):
# measured maxima over 12 seeds in the comments
BF16_FRAC = {
    "eager": dict(logits=1e-3, cache=2e-3),   # 2e-5, 4.5e-4
    # port's kernel call site (sequential ssd_ref on the CPU) against the
    # chunked form: fp32 sums in another order, then bf16 flips
    "eager_kernel": dict(logits=1e-2, cache=2e-2),   # 2.5e-3, 5.7e-3
    "jit": dict(logits=5e-2, cache=6e-2),     # 2.2e-2, 2.5e-2
}


def _close(got, want, dtype, frac=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= frac * scale, (err, scale, frac)


@pytest.fixture
def jax_kernel_interpret(monkeypatch):
    """JAX's ``mamba_block(use_kernel=True)`` runs the Pallas kernel as
    the JAX package's own tests run it on the CPU: in interpret mode."""
    real = jssd_ops.ssd
    monkeypatch.setattr(jssd_ops, "ssd",
                        lambda *a, **k: real(*a, **k, interpret=True))


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


def _tokens(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def test_config_matches_jax(cfgs):
    cfg, jcfg = cfgs
    for f in ("num_layers", "d_model", "vocab_size", "ssm_state_dim",
              "ssm_head_dim", "ssm_chunk", "ssm_conv_width", "d_inner",
              "ssm_num_heads", "num_blocks", "tie_embeddings", "norm_type"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.padded_vocab() == jcfg.padded_vocab()
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_state_dim,
            cfg.ssm_head_dim, cfg.ssm_chunk) == (2, 64, 16, 8, 8)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.ssm_num_heads,
            full.ssm_head_dim, full.ssm_state_dim, full.ssm_chunk) == \
        (24, 768, 24, 64, 128, 256)
    assert M.count_model_params(cfg) == JM.count_model_params(jcfg)
    # the encoder-decoder is registered too, with JAX's config
    from repro.configs import get_config as jget_config
    assert dataclasses.asdict(get_config("whisper-small")) == \
        dataclasses.asdict(jget_config("whisper-small"))


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


def test_init_params_follows_the_defs(cfgs):
    cfg = cfgs[0]
    defs = M.model_defs(cfg)
    a = init_params(defs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(defs, torch.Generator().manual_seed(3), "cpu")
    mix = a["blocks"]["s0"]["mixer"]
    assert mix["w_x"].shape == (2, 64, 16, 8)
    assert mix["w_x"].dtype == torch.bfloat16
    assert (mix["D_skip"] == 1).all() and (mix["A_log"] == 0).all()
    assert torch.equal(a["embed"], b["embed"])
    # "normal": std 0.02; "scaled": 1/sqrt(fan_in)
    assert abs(a["embed"].float().std().item() - 0.02) < 0.002
    assert abs(mix["w_x"].float().std().item() - 64 ** -0.5) < 0.01
    assert sum(t.numel() for t in jax.tree.leaves(a)) == \
        M.count_model_params(cfg)


def test_hybrid_layer_kinds_build_and_match_jax():
    """A hybrid of Mamba and MoE layers builds and matches JAX (f32,
    prefill logits and caches within the f32 tolerances); with
    cross-attention layers in it, it builds JAX's parameter and cache
    trees and prefills to JAX's logits and caches."""
    change = dict(family="hybrid", num_heads=4, num_kv_heads=2, head_dim=16,
                  attn_layer_period=2, num_experts=4, experts_per_token=2,
                  moe_d_ff=64, capacity_factor=2.0, block_period=2)
    cfg = dataclasses.replace(reduced_config(ARCH), **change)
    jcfg = dataclasses.replace(jreduced(ARCH), **change)
    assert [cfg.layer_kind(l) for l in range(2)] == ["attn", "ssm"]
    assert all(cfg.is_moe_layer(l) for l in range(2))
    assert M.cache_shapes(cfg, 2, 8) == JM.cache_shapes(jcfg, 2, 8)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(JM.model_defs(jcfg), jax.random.key(4)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(4).integers(0, 256, (2, 12)) \
        .astype(np.int32)
    lt, ct = M.forward_prefill(cfg, tp, torch.from_numpy(tok))
    lj, cj = jax.jit(lambda p, t: JM.forward_prefill(jcfg, p, t))(
        jp, jnp.asarray(tok))
    np.testing.assert_allclose(lt.numpy()[:, :256],
                               np.asarray(lj)[:, :256], **F32_TOL)
    assert set(ct["blocks"]) == {"s0", "s1"}
    for k, v in cj["blocks"]["s1"].items():
        np.testing.assert_allclose(ct["blocks"]["s1"][k].numpy(),
                                   np.asarray(v), **F32_TOL)
    xchange = dict(cross_attn_period=2, num_image_tokens=16,
                   attn_layer_period=0)
    cross = dataclasses.replace(cfg, **xchange)
    jcross = dataclasses.replace(jcfg, **xchange)
    assert [cross.layer_kind(l) for l in range(2)] == ["cross", "attn"]
    assert jax.tree.map(lambda d: (d.shape, d.init),
                        JM.model_defs(jcross)) == \
        jax.tree.map(lambda d: (d.shape, d.init), M.model_defs(cross),
                     is_leaf=lambda d: not isinstance(d, dict))
    assert M.cache_shapes(cross, 2, 8) == JM.cache_shapes(jcross, 2, 8)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(JM.model_defs(jcross), jax.random.key(5)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    img = np.random.default_rng(5).standard_normal((2, 16, 64)) \
        .astype(np.float32)
    lt, ct = M.forward_prefill(cross, tp, torch.from_numpy(tok),
                               img_embeds=torch.from_numpy(img))
    lj, cj = jax.jit(lambda p, t, e: JM.forward_prefill(
        jcross, p, t, img_embeds=e))(jp, jnp.asarray(tok), jnp.asarray(img))
    np.testing.assert_allclose(lt.numpy()[:, :256],
                               np.asarray(lj)[:, :256], **F32_TOL)
    for k, v in cj["blocks"]["s0"].items():
        assert ct["blocks"]["s0"][k].shape == (1, 2, 16, 2, 16)
        np.testing.assert_allclose(ct["blocks"]["s0"][k].numpy(),
                                   np.asarray(v), **F32_TOL)


def _layer0(tp, jp):
    return ({k: v[0] for k, v in tp["blocks"]["s0"]["mixer"].items()},
            jax.tree.map(lambda a: a[0], jp["blocks"]["s0"]["mixer"]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_block_matches_jax(cfgs, jparams, dtype, use_kernel,
                                 jax_kernel_interpret):
    """S = 21 is not a multiple of the chunk: the pad path of both SSD
    forms. ``use_kernel=True`` is the kernel's call site in both
    packages: the wrapper's plain version here, the Pallas kernel in
    interpret mode in JAX. JAX runs op by op (no jit around the block)."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    lt, lj = _layer0(tp, jp)
    x = np.random.default_rng(1).standard_normal((2, 21, 64)) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(DT[dtype][1])
    xt = torch.from_numpy(_np(xj)).to(DT[dtype][0])
    before = ssd_kernel.ssd_scan.launches
    out, (fs, tail) = S.mamba_block(cfg, lt, xt, use_kernel=use_kernel)
    assert ssd_kernel.ssd_scan.launches == before
    oj, (fj, tj) = JS.mamba_block(jcfg, lj, xj, use_kernel=use_kernel)
    assert out.dtype == DT[dtype][0] and out.shape == oj.shape
    frac = BF16_FRAC["eager_kernel" if use_kernel else "eager"]["cache"]
    _close(_t(out), _np(oj), dtype, frac)
    _close(_t(fs), _np(fj), dtype, frac)
    _close(_t(tail), _np(tj), dtype, frac)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_block_decode_matches_jax(cfgs, jparams, dtype):
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    lt, lj = _layer0(tp, jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    shapes = S.ssm_cache_shape(cfg, 2)
    cache = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    jd = DT[dtype][1]
    xj = jnp.asarray(x).astype(jd)
    cj = {k: jnp.asarray(v).astype(jd) for k, v in cache.items()}
    ct = {k: torch.from_numpy(_np(v)).to(DT[dtype][0]) for k, v in cj.items()}
    out, new = S.mamba_block_decode(
        cfg, lt, torch.from_numpy(_np(xj)).to(DT[dtype][0]), ct)
    oj, nj = JS.mamba_block_decode(jcfg, lj, xj, cj)
    frac = BF16_FRAC["eager"]["cache"]
    _close(_t(out), _np(oj), dtype, frac)
    for k in ("state", "conv"):
        assert new[k].dtype == ct[k].dtype
        _close(_t(new[k]), _np(nj[k]), dtype, frac)


def _run_jax(mode, fn, *args):
    if mode == "eager":
        with jax.disable_jit():
            return fn(*args)
    return fn(*args)


def _caches_close(ct, cj, dtype, frac):
    for k in ("state", "conv"):
        _close(_t(ct["blocks"]["s0"][k]), _np(cj["blocks"]["s0"][k]), dtype,
               frac)


@pytest.mark.parametrize("mode,use_kernel", [("eager", None),
                                             ("eager", True),
                                             ("jit", None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_prefill_matches_jax(cfgs, jparams, dtype, mode,
                                     use_kernel):
    """Against JAX op by op (``eager``) and compiled (``jit``, as the JAX
    package runs it); ``use_kernel=True`` is the port's SSD kernel call
    site (its plain version on the CPU) against JAX's ``ssd_chunked``."""
    cfg, jcfg = cfgs
    tp, jp = _params(jparams, dtype)
    tok = _tokens(2, 29, 4, cfg.vocab_size)
    logits, caches = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                                       use_kernel=use_kernel)
    lj, cj = _run_jax(mode, lambda: JM.forward_prefill(jcfg, jp,
                                                      jnp.asarray(tok)))
    assert logits.shape == lj.shape == (2, cfg.padded_vocab())
    assert (logits[:, cfg.vocab_size:] == -1e9).all()
    frac = BF16_FRAC["eager_kernel" if use_kernel else mode]
    _close(_t(logits), _np(lj), dtype, frac["logits"])
    assert caches["prefix"] == {} and set(caches["blocks"]) == {"s0"}
    for k, shape in M.cache_shapes(cfg, 2, 8)["blocks"]["s0"].items():
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
    _close(_t(logits), _np(lj), dtype, BF16_FRAC[mode]["logits"])
    _caches_close(new, nj, dtype, BF16_FRAC[mode]["cache"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_decode_equals_prefill(cfgs, jparams, dtype):
    """prefill(S-1) + decode at position S-1 == prefill(S)'s last logits.
    The caches hold the state in the activation dtype, so in bf16 the
    carried state is rounded once and the decode step's conv runs in fp32
    where the prefill's rounds to bf16 (as in the JAX package): 3% of the
    largest logit (measured 1.2% over 12 seeds)."""
    cfg = cfgs[0]
    tp, _ = _params(jparams, dtype)
    tok = torch.from_numpy(_tokens(2, 24, 7, cfg.vocab_size))
    full, _ = M.forward_prefill(cfg, tp, tok)
    _, caches = M.forward_prefill(cfg, tp, tok[:, :-1])
    step, _ = M.forward_decode(cfg, tp, tok[:, -1:], 23, caches)
    _close(_t(step)[:, :cfg.vocab_size], _t(full)[:, :cfg.vocab_size],
           dtype, 3e-2)
