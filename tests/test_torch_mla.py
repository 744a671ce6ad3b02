"""The port's MLA (``repro_torch.models.layers.mla_*``: DeepSeek's latent
attention, the prefill form and the absorbed decode form) against the
JAX package on the CPU, at ``reduced_config("deepseek-v2-lite-16b")``
(4 heads, q/k 16 + 8 rope wide, v 16, kv latent 32), and the kernel's
plain version at the head widths the wider kernels take.

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit; inputs are drawn with numpy from a seed.

- ``f32`` (parameters and activations cast to fp32): the packages differ
  only in fp32 sum order and ulps of exp/cos/sin — atol 1e-5, rtol 1e-4.
- ``bf16``, as the model runs, normwise (max |port - jax| over max
  |jax|): 2e-2 on the prefill's plain path and the caches (measured
  3.9e-3), 4e-2 on its kernel path, which computes p·V in fp32 where JAX
  rounds p to bf16 (measured 9.8e-3), and 2e-2 on decode, which JAX
  computes in fp32 from bf16 caches (measured 3.9e-3); maxima over 12
  seeds.
- ``attention_ref`` (the kernel's plain version) at (d 192, dv 128),
  (160, 160) and (256, 256) against JAX's Pallas ``flash_attention`` in
  interpret mode, within the JAX package's kernel tolerances (2e-5 fp32,
  2e-2 bf16).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.kernels.attention.kernel import flash_attention as jflash
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attention import kernel as attn_kernel, ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.params import init_params

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_FRAC = dict(plain=2e-2, kernel=4e-2, decode=2e-2)
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def cfgs():
    return reduced_config(ARCH), jreduced(ARCH)


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jinit(JM.model_defs(cfgs[1]), jax.random.key(0))


def _mixer(jparams, dtype):
    """Layer 0's (the dense prefix layer's) MLA weights, both packages."""
    jp = jax.tree.map(lambda a: a.astype(DT[dtype][1]),
                      jparams["prefix"]["p0"]["mixer"])
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp


def _both(a, dtype):
    j = jnp.asarray(a).astype(DT[dtype][1])
    return torch.from_numpy(np.array(j.astype(jnp.float32))) \
        .to(DT[dtype][0]), j


def _close(got, want, dtype, frac=None):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= frac * np.abs(want).max()


def test_mla_defs_match_jax(cfgs):
    cfg, jcfg = cfgs
    tdefs, jdefs = L.mla_defs(cfg), JL.mla_defs(jcfg)
    assert sorted(tdefs) == sorted(jdefs)
    for k in tdefs:
        assert tdefs[k].shape == jdefs[k].shape
        assert (tdefs[k].init, tdefs[k].fan_in) == (jdefs[k].init,
                                                    jdefs[k].fan_in)
    full = L.mla_defs(get_config(ARCH))
    assert full["wq"].shape == (2048, 16, 192)
    assert full["w_uv"].shape == (16, 512, 128)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_attention_matches_jax(cfgs, jparams, dtype, use_kernel):
    """Prefill MLA and its cache: JAX's ``mla_attention`` runs
    ``blockwise_attention``; the port's kernel call site (its plain
    version here, no launch) computes the same function."""
    cfg, jcfg = cfgs
    tp, jp = _mixer(jparams, dtype)
    xt, xj = _both(np.random.default_rng(1).standard_normal((2, 21, 64))
                   .astype(np.float32), dtype)
    before = attn_kernel.flash_attention.launches
    out, (ckv, kr) = L.mla_attention(cfg, tp, xt, torch.arange(21),
                                     use_kernel=use_kernel)
    assert attn_kernel.flash_attention.launches == before
    with jax.disable_jit():
        oj, (ckvj, krj) = JL.mla_attention(jcfg, jp, xj, jnp.arange(21))
    assert out.dtype == DT[dtype][0]
    assert tuple(ckv.shape) == (2, 21, 32) and tuple(kr.shape) == (2, 21, 8)
    _close(out, oj, dtype, BF16_FRAC["kernel" if use_kernel else "plain"])
    _close(ckv, ckvj, dtype, BF16_FRAC["plain"])
    _close(kr, krj, dtype, BF16_FRAC["plain"])


def test_mla_kernel_path_takes_q_192_wide_at_full_width(monkeypatch):
    """At DeepSeek-V2-Lite's widths the kernel call gets q and k 192 wide
    (128 nope + 64 rope) and v 128 wide, and its default scale
    1/sqrt(192) is MLA's; the positions must be consecutive."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=32, num_heads=2,
                              kv_lora_rank=16)
    p = init_params(L.mla_defs(cfg), torch.Generator().manual_seed(0),
                    "cpu")
    seen = []

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return attention_ref(q, k, v, causal=kw["causal"],
                             window=kw["window"])
    monkeypatch.setattr(ops, "attention", spy)
    x = torch.randn((1, 9, 32), generator=torch.Generator().manual_seed(1))
    out, _ = L.mla_attention(cfg, p, x, torch.arange(9), use_kernel=True)
    plain, _ = L.mla_attention(cfg, p, x, torch.arange(9), use_kernel=False)
    assert seen == [((1, 9, 2, 192), (1, 9, 2, 192), (1, 9, 2, 128),
                     dict(causal=True, window=None))]
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-4)
    assert math.isclose(1.0 / math.sqrt(192),
                        1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim))
    with pytest.raises(ValueError, match="consecutive"):
        L.mla_attention(cfg, p, x, torch.tensor([0, 1, 2, 4, 5, 6, 7, 8, 9]),
                        use_kernel=True)


@pytest.mark.parametrize("pos", [5, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_attention_decode_matches_jax(cfgs, jparams, dtype, pos):
    """The absorbed form against an 8-slot latent cache, slots < pos
    valid (pos 8: all of them), the new token attended separately."""
    cfg, jcfg = cfgs
    tp, jp = _mixer(jparams, dtype)
    rng = np.random.default_rng(2)
    xt, xj = _both(rng.standard_normal((2, 1, 64)).astype(np.float32), dtype)
    ct, cj = _both(rng.standard_normal((2, 8, 32)).astype(np.float32), dtype)
    kt, kj = _both(rng.standard_normal((2, 8, 8)).astype(np.float32), dtype)
    out, (ckv, kr) = L.mla_attention_decode(cfg, tp, xt, pos,
                                            {"ckv": ct, "kr": kt})
    with jax.disable_jit():
        oj, (ckvj, krj) = JL.mla_attention_decode(jcfg, jp, xj, pos,
                                                  {"ckv": cj, "kr": kj})
    assert tuple(out.shape) == (2, 1, 64) and out.dtype == DT[dtype][0]
    for a, b in ((out, oj), (ckv, ckvj), (kr, krj)):
        _close(a, b, dtype, BF16_FRAC["decode"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_caches_and_decode_match_jax(cfgs, jparams, dtype):
    """A 16-token prefill's MLA caches (``{"ckv", "kr"}`` per layer,
    stacked over blocks) and one decode step from them, both packages;
    the cache shapes are JAX's."""
    cfg, jcfg = cfgs
    jp = jax.tree.map(lambda a: a.astype(DT[dtype][1]), jparams)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(3).integers(0, 256, (2, 16)) \
        .astype(np.int32)
    nxt = np.random.default_rng(4).integers(0, 256, (2, 1)).astype(np.int32)
    _, ct = M.forward_prefill(cfg, tp, torch.from_numpy(tok),
                              use_kernel=False)
    with jax.disable_jit():
        _, cj = JM.forward_prefill(jcfg, jp, jnp.asarray(tok))
        lj, nj = JM.forward_decode(jcfg, jp, jnp.asarray(nxt), 16, cj)
    assert M.cache_shapes(cfg, 2, 16) == JM.cache_shapes(jcfg, 2, 16)
    assert set(ct["prefix"]["p0"]) == {"ckv", "kr"}
    for part, key in (("prefix", "p0"), ("blocks", "s0")):
        for k in ("ckv", "kr"):
            _close(ct[part][key][k], cj[part][key][k], dtype,
                   BF16_FRAC["plain"])
    lt, nt = M.forward_decode(cfg, tp, torch.from_numpy(nxt), 16,
                              params_from_jax(jax.tree.map(np.asarray, cj),
                                              "cpu"))
    V = cfg.vocab_size
    _close(lt[:, :V], np.asarray(lj)[:, :V], dtype, BF16_FRAC["decode"])
    for k in ("ckv", "kr"):
        _close(nt["blocks"]["s0"][k], nj["blocks"]["s0"][k], dtype,
               BF16_FRAC["decode"])


@pytest.mark.parametrize("d,dv,H,KV,causal,window,dtype", [
    (192, 128, 4, 4, True, None, "f32"),     # MLA
    (192, 128, 4, 4, True, None, "bf16"),
    (160, 160, 4, 2, True, None, "f32"),     # StableLM
    (160, 160, 4, 2, False, 20, "bf16"),
    (256, 256, 2, 1, True, None, "f32"),     # the widest the kernels take
    (256, 256, 2, 2, True, 10, "bf16"),
])
def test_attention_ref_matches_jax_kernel_wide_heads(d, dv, H, KV, causal,
                                                     window, dtype):
    """The kernel's plain version at the head widths C3 opened against
    JAX's Pallas kernel (interpret mode), which has no width cap."""
    rng = np.random.default_rng(d + dv)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 64, H, d), (1, 64, KV, d), (1, 64, KV, dv))]
    t = [torch.from_numpy(a).to(DT[dtype][0]) for a in arrs]
    j = [jnp.asarray(x.float().numpy()).astype(DT[dtype][1]) for x in t]
    got = attention_ref(*t, causal=causal, window=window)
    want = jflash(*j, causal=causal, window=window, block_q=32, block_kv=32,
                  interpret=True)
    assert got.shape == (1, 64, H, dv) and got.dtype == DT[dtype][0]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATTN_TOL[dtype], rtol=ATTN_TOL[dtype])


# ------------------------------------------------ how the bounds were set --

def _measure_jax_parity(seeds=range(12)):
    """Largest normwise bf16 error of the port's MLA against JAX's (op by
    op) over ``seeds``: prefill output and caches on the plain path, the
    prefill output on the kernel call site, and the decode step."""
    cfg, jcfg = reduced_config(ARCH), jreduced(ARCH)
    worst = dict(plain=0.0, kernel=0.0, decode=0.0)

    def note(key, got, want):
        got, want = got.float().numpy(), _np(want)
        worst[key] = max(worst[key], float(np.abs(got - want).max()
                                           / np.abs(want).max()))

    def _np(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    for seed in seeds:
        tp, jp = _mixer(jinit(JM.model_defs(jcfg), jax.random.key(seed)),
                        "bf16")
        rng = np.random.default_rng(100 + seed)
        xt, xj = _both(rng.standard_normal((2, 21, 64)).astype(np.float32),
                       "bf16")
        with jax.disable_jit():
            oj, (cj, kj) = JL.mla_attention(jcfg, jp, xj, jnp.arange(21))
        for use_kernel in (False, True):
            out, (ckv, kr) = L.mla_attention(cfg, tp, xt, torch.arange(21),
                                             use_kernel=use_kernel)
            note("kernel" if use_kernel else "plain", out, oj)
        note("plain", ckv, cj)
        note("plain", kr, kj)
        x1t, x1j = _both(rng.standard_normal((2, 1, 64)).astype(np.float32),
                         "bf16")
        ct, cjj = _both(rng.standard_normal((2, 8, 32)).astype(np.float32),
                        "bf16")
        kt, kjj = _both(rng.standard_normal((2, 8, 8)).astype(np.float32),
                        "bf16")
        out, new = L.mla_attention_decode(cfg, tp, x1t, 5,
                                          {"ckv": ct, "kr": kt})
        with jax.disable_jit():
            oj, newj = JL.mla_attention_decode(jcfg, jp, x1j, 5,
                                               {"ckv": cjj, "kr": kjj})
        note("decode", out, oj)
        for a, b in zip(new, newj):
            note("decode", a, b)
    return worst


def deep_config(S=512):
    """DeepSeek-V2-Lite cut to d_model 256 (2 heads, kv latent 64, d_ff
    512, MoE 64 x 64 wide, vocab 4096) at its full depth (27 layers),
    head widths (q/k 192, v 128), routing (64 experts, top-6, 2 shared,
    capacity 1.25) and rope: what chip_smoke.py's DEEPSEEK_TOL is
    measured on, with batch 4 so that decode routes 4 tokens at C = 1
    as on the card."""
    return dataclasses.replace(get_config(ARCH), d_model=256, num_heads=2,
                               num_kv_heads=2, kv_lora_rank=64, d_ff=512,
                               moe_d_ff=64, vocab_size=4096)


def _measure_kernel_path(seeds=range(6), S=512, B=4):
    """Relative RMS error of the kernel path (``use_kernel=True``: its
    plain version here) against ``blockwise_attention``, as
    ``chip_smoke.py`` phase 12 measures it on the card: MLA outputs layer
    by layer on the same inputs, one absorbed decode step on the first
    S-1 latents against the prefill's last row, the tokens whose top-K
    expert set differs between the two paths' layer inputs, last-token
    logits end to end, and prefill(S-1) + decode against prefill(S) with
    the decode step's routing of the last tokens
    (``chip_smoke._decode_reference``) and against the plain
    prefill(S)."""
    import importlib.util
    from pathlib import Path
    from repro_torch.models.params import init_params as tinit
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    cfg = deep_config(S)
    V, K = cfg.vocab_size, cfg.experts_per_token
    pos = torch.arange(S)
    w = dict(layer=0.0, decode_layer=0.0, logits=0.0, decode_logits=0.0,
             decode_vs_prefill=0.0, flips=0)
    for seed in seeds:
        p = tinit(M.model_defs(cfg), torch.Generator().manual_seed(seed),
                  "cpu")
        tok = torch.randint(0, V, (B, S), generator=torch.Generator()
                            .manual_seed(50 + seed))
        lk, _ = M.forward_prefill(cfg, p, tok, use_kernel=True)
        lp, _ = M.forward_prefill(cfg, p, tok, use_kernel=False)
        w["logits"] = max(w["logits"], rel(lk[:, :V], lp[:, :V]))
        _, c = M.forward_prefill(cfg, p, tok[:, :-1], use_kernel=True)
        st, _ = M.forward_decode(cfg, p, tok[:, -1:], S - 1, c)
        ref = smoke._decode_reference(cfg, p, tok, use_kernel=True)
        w["decode_logits"] = max(w["decode_logits"],
                                 rel(st[:, :V], ref[:, :V]))
        w["decode_vs_prefill"] = max(w["decode_vs_prefill"],
                                     rel(st[:, :V], lk[:, :V]))
        x = M._embed(cfg, p, tok)
        for l in range(cfg.num_layers):
            lp_ = smoke._layer_params(cfg, p, l)
            h = L.apply_norm(cfg, lp_["norm1"], x)
            yk, (ckv, kr) = L.mla_attention(cfg, lp_["mixer"], h, pos,
                                            use_kernel=True)
            yp, _ = L.mla_attention(cfg, lp_["mixer"], h, pos,
                                    use_kernel=False)
            w["layer"] = max(w["layer"], rel(yk, yp))
            yd, _ = L.mla_attention_decode(
                cfg, lp_["mixer"], h[:, -1:], S - 1,
                {"ckv": ckv[:, :-1], "kr": kr[:, :-1]})
            w["decode_layer"] = max(w["decode_layer"], rel(yd, yk[:, -1:]))
            if cfg.is_moe_layer(l):
                sets = [L.moe_route(cfg, lp_["ffn"]["router"],
                                    L.apply_norm(cfg, lp_["norm2"], x + y)
                                    .reshape(-1, cfg.d_model))["idx"]
                        .sort(-1).values for y in (yk, yp)]
                w["flips"] += int((sets[0] != sets[1]).any(-1).sum())
            x, _ = M._ffn(cfg, lp_, x + yk, cfg.is_moe_layer(l))
        print(seed, w, flush=True)
    return w


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_mla.py: the measurements
    # behind BF16_FRAC here and chip_smoke.py's DEEPSEEK_TOL
    import sys
    torch.set_num_threads(4)
    if "--kernel-path" not in sys.argv:
        print("port vs JAX, bf16, normwise:", _measure_jax_parity())
    else:
        print("kernel path vs blockwise_attention, rel RMS:",
              _measure_kernel_path())
