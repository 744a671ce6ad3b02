"""Every architecture of the model zoo in the port against the JAX
package on the CPU: the configs of all ten registered archs, and prefill and decode of the six that came with MLA and MoE
(``stablelm-12b``, ``llama3-405b``, ``qwen2-7b``, ``mixtral-8x7b``,
``deepseek-v2-lite-16b``, ``jamba-1.5-large-398b``) at their
``reduced_config`` (d_model 64; DeepSeek with MLA, a dense first layer
and MoE blocks; Mixtral's MoE under a 16-token window; Jamba's 16-layer
super-blocks of SSM, attention and MoE).

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit; Qwen2's QKV biases are redrawn non-zero in
both (the zero init would hide a missing add). Tokens are drawn with
numpy from a seed. JAX runs prefill plus one decode step once per arch
and dtype (shared by the tests of a module): compiled in ``f32``, op by
op in ``bf16``, since a compiled JAX function lets XLA skip the
intermediate bf16 roundings the port (and JAX op by op) takes — on
Jamba compiled JAX lies 61% (logits, normwise) from the port, as far as
it lies from its own op-by-op run.

Comparisons are normwise, ``max |port - jax| <= frac * max |jax|``, each
frac ~4x the largest error measured over 8 seeds (``PYTHONPATH=src
python tests/test_torch_archs.py`` prints them):
- ``f32`` (parameters cast to fp32): fp32 sum order only, 1e-5
  (measured at most 1.3e-6); Jamba 2e-3 (measured 4.0e-4 on the caches:
  its random-weight stack of SSM and MoE layers is ill-conditioned, so
  fp32 rounding grows through its 16 layers);
- ``bf16``: 2e-2 on prefill logits and caches (measured at most 4.6e-3)
  and 1e-5 on the decode step from JAX's caches (1.7e-7); Jamba 0.5,
  0.75 and 5e-2 (measured 0.12, 0.19 and 1.2e-2: its random-weight
  stack carries a flipped bf16 rounding far, routing or not; with its
  routers zeroed the logits lie 0.37 apart, ``--fixed``). Jamba's bf16
  layers are held one by one at 2e-2 and bit by bit in
  ``tests/test_torch_archs_bf16.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs.base import SKIPPED_CELLS as JSKIPPED
from repro.configs.reduced import reduced_config as jreduced
from repro.models import model as JM
from repro.models.params import init_params as jinit
from repro_torch.configs import (ARCH_NAMES, SKIPPED_CELLS, all_configs,
                                 cell_is_skipped, get_config)
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M

torch.set_num_threads(1)

NEW_ARCHS = ["stablelm-12b", "llama3-405b", "qwen2-7b", "mixtral-8x7b",
             "deepseek-v2-lite-16b", "jamba-1.5-large-398b"]
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}
S_PRE = 24
JAMBA = "jamba-1.5-large-398b"
# normwise fractions (see the docstring)
F32_FRAC = {"": 1e-5, JAMBA: 2e-3}
# bf16: (prefill logits, caches, decode step)
BF16_FRAC = {"": (2e-2, 2e-2, 1e-5), JAMBA: (0.5, 0.75, 5e-2)}


def _fix_routing(tree):
    """Every router zeroed: each token's probabilities are all 1/E, so
    both packages send it to experts 0 .. K-1 (ties go to the lowest
    expert) whatever its activations, and no bf16 rounding moves it."""
    if isinstance(tree, dict):
        return {k: jnp.zeros_like(v) if k == "router" else _fix_routing(v)
                for k, v in tree.items()}
    return tree


def _jparams(arch, dtype, seed=0, fixed_routing=False):
    """JAX's parameter tree of the reduced arch: every leaf cast to fp32
    for ``f32``, the defs' dtypes for ``bf16`` (bf16, the router fp32);
    Qwen2's QKV biases redrawn non-zero; the routers zeroed for
    ``fixed_routing`` (``_fix_routing``)."""
    jp = jinit(JM.model_defs(jreduced(arch)), jax.random.key(seed))
    if fixed_routing:
        jp = _fix_routing(jp)
    if jreduced(arch).qkv_bias:
        rng = np.random.default_rng(1000 + seed)
        s0 = jp["blocks"]["s0"]
        mixer = {k: jnp.asarray(0.1 * rng.standard_normal(v.shape))
                 .astype(v.dtype) if k in ("bq", "bk", "bv") else v
                 for k, v in s0["mixer"].items()}
        jp = {**jp, "blocks": {**jp["blocks"],
                               "s0": {**s0, "mixer": mixer}}}
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp


def _tokens(seed, B=2, S=S_PRE, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return a.float().numpy()


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_run(arch, jp, tok, nxt, eager=False):
    """JAX's prefill of ``tok`` and one decode step of ``nxt`` from its
    caches: compiled together, or op by op (``eager``)."""
    jcfg = jreduced(arch)

    def run(p, t, n):
        logits, caches = JM.forward_prefill(jcfg, p, t)
        step, deltas = JM.forward_decode(jcfg, p, n, t.shape[1], caches)
        return logits, caches, step, deltas

    if eager:
        with jax.disable_jit():
            return run(jp, jnp.asarray(tok), jnp.asarray(nxt))
    return jax.jit(run)(jp, jnp.asarray(tok), jnp.asarray(nxt))


@pytest.fixture(scope="module")
def runs():
    """(arch, dtype) -> the parameters of both packages and JAX's
    results, computed once per module."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jp = _jparams(arch, dtype)
            tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
            tok, nxt = _tokens(4), _tokens(5, S=1)
            cache[arch, dtype] = (tp, tok, nxt,
                                  _jax_run(arch, jp, tok, nxt,
                                           eager=dtype == "bf16"), jp)
        return cache[arch, dtype]
    return get


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


# ----------------------------------------------------------- configs -------

def test_registry_holds_every_jax_arch():
    """The port registers every JAX arch in JAX's order, the
    encoder-decoder (Whisper) and the cross-attention model (Llama
    vision) included; an unknown name raises ``KeyError`` listing them."""
    assert ARCH_NAMES == JARCH_NAMES
    assert sorted(all_configs()) == sorted(ARCH_NAMES)
    for arch in ("whisper-small", "llama-3.2-vision-90b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    with pytest.raises(KeyError, match="whisper-small"):
        get_config("no-such-arch")
    assert SKIPPED_CELLS == JSKIPPED
    assert cell_is_skipped("deepseek-v2-lite-16b", "long_500k") \
        == "MLA is full attention over latents"
    assert cell_is_skipped("jamba-1.5-large-398b", "long_500k") is None


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_and_counts_match_jax(arch):
    """Every field of the full and the reduced config, the parameter
    count and the active-parameter count equal the JAX package's."""
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (reduced_config(arch), jreduced(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.v_hd, cfg.num_blocks, cfg.padded_vocab()) == \
            (jcfg.v_hd, jcfg.num_blocks, jcfg.padded_vocab())
        assert [cfg.layer_kind(l) for l in range(cfg.num_layers)] == \
            [jcfg.layer_kind(l) for l in range(jcfg.num_layers)]
        assert [cfg.is_moe_layer(l) for l in range(cfg.num_layers)] == \
            [jcfg.is_moe_layer(l) for l in range(jcfg.num_layers)]
        assert M.count_model_params(cfg) == JM.count_model_params(jcfg)
        assert M.active_params(cfg) == JM.active_params(jcfg)
        assert M.cache_shapes(cfg, 2, 40) == JM.cache_shapes(jcfg, 2, 40)


def test_deepseek_full_width_counts():
    """DeepSeek-V2-Lite at full width: 15.7 B parameters, 14.4 B of them
    in the 26 MoE layers' routed experts, 2.7 B active per token."""
    cfg = get_config("deepseek-v2-lite-16b")
    assert M.count_model_params(cfg) == 15_706_484_224
    assert M.active_params(cfg) == 2_661_150_208
    defs = M.model_defs(cfg)
    ffn = defs["blocks"]["s0"]["ffn"]
    assert ffn["wg"].shape == (26, 64, 2048, 1408)
    assert sum(ffn[k].shape[0] * ffn[k].shape[1] * ffn[k].shape[2]
               * ffn[k].shape[3] for k in ("wg", "wu", "wd")) \
        == 14_394_851_328
    assert ffn["router"].dtype == torch.float32
    assert ffn["shared"]["wg"].shape == (26, 2048, 2816)
    assert set(defs["prefix"]["p0"]["ffn"]) == {"wg", "wu", "wd"}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_params_cross_bit_for_bit(arch):
    """Every MLA and MoE leaf (the fp32 router included) of reduced
    DeepSeek and Jamba crosses with its dtype, shape and bits."""
    jp = _jparams(arch, "bf16", 3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jl, tl = _leaves(jax.tree.map(np.asarray, jp)), _leaves(tp)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    assert [k for k, _ in tl] == [
        k for k, _ in _leaves(M.model_defs(reduced_config(arch)))]
    routers = 0
    for (k, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        if k.endswith("router"):
            routers += 1
            assert t.dtype == torch.float32 and a.dtype == np.float32
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
    # DeepSeek: the MoE blocks' s0; Jamba: s1, s3, s5 and s7
    assert routers == (1 if arch.startswith("deepseek") else 4)


# ------------------------------------------------- prefill and decode ------

def _check(arch, dtype, what, got, want):
    key = arch if arch == JAMBA else ""
    frac = F32_FRAC[key] if dtype == "f32" else BF16_FRAC[key][
        ("logits", "cache", "decode").index(what)]
    err = _err(got, want)
    assert err <= frac, (arch, dtype, what, err, frac)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_prefill_matches_jax(runs, arch):
    """(bf16: tests/test_torch_archs_bf16.py, which runs JAX op by op.)"""
    prefill_case(runs, arch, "f32")


def prefill_case(runs, arch, dtype):
    cfg = reduced_config(arch)
    tp, tok, _, (lj, cj, _, _), _ = runs(arch, dtype)
    logits, caches = M.forward_prefill(cfg, tp, torch.from_numpy(tok))
    V = cfg.vocab_size
    assert logits.shape == (2, cfg.padded_vocab())
    assert bool((logits[:, V:] == -1e9).all())
    _check(arch, dtype, "logits", _t(logits)[:, :V], _np(lj)[:, :V])
    shapes = M.cache_shapes(cfg, 2, S_PRE)
    jl = _leaves(jax.tree.map(_np, cj))
    tl = _leaves(caches)
    assert [k for k, _ in tl] == [k for k, _ in jl] == \
        [k for k, _ in _leaves(shapes)] != []
    for (k, a), (_, t) in zip(jl, tl):
        assert t.dtype == DT[dtype][0]
        assert tuple(t.shape) == a.shape == dict(_leaves(shapes))[k]
        _check(arch, dtype, "cache", _t(t), a)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_decode_matches_jax(runs, arch):
    decode_case(runs, arch, "f32")


def decode_case(runs, arch, dtype):
    """One decode step from JAX's prefill caches, carried across."""
    cfg = reduced_config(arch)
    tp, tok, nxt, (_, cj, sj, nj), _ = runs(arch, dtype)
    ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    step, deltas = M.forward_decode(cfg, tp, torch.from_numpy(nxt), S_PRE,
                                    ct)
    V = cfg.vocab_size
    _check(arch, dtype, "decode", _t(step)[:, :V], _np(sj)[:, :V])
    jl, tl = _leaves(jax.tree.map(_np, nj)), _leaves(deltas)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (k, a), (_, t) in zip(jl, tl):
        _check(arch, dtype, "decode", _t(t), a)


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_equals_prefill(runs, arch, use_kernel):
    """prefill(S-1) + decode at S-1 == prefill(S)'s last logits (f32; the
    reduced MoE configs are dropless, so the decode step routes its token
    as the prefill does), on the plain path and on the kernel call sites
    (their plain versions here)."""
    cfg = reduced_config(arch)
    tp, tok, _, _, _ = runs(arch, "f32")
    t = torch.from_numpy(tok)
    full, _ = M.forward_prefill(cfg, tp, t, use_kernel=use_kernel)
    _, caches = M.forward_prefill(cfg, tp, t[:, :-1], use_kernel=use_kernel)
    step, _ = M.forward_decode(cfg, tp, t[:, -1:], S_PRE - 1, caches)
    V = cfg.vocab_size
    assert _err(_t(step)[:, :V], _t(full)[:, :V]) \
        <= F32_FRAC[arch if arch == JAMBA else ""]


def test_qwen2_biases_are_drawn_and_used(runs):
    """The biases are non-zero, and dropping them moves the logits."""
    cfg = reduced_config("qwen2-7b")
    tp, tok, _, _, _ = runs("qwen2-7b", "f32")
    mixer = tp["blocks"]["s0"]["mixer"]
    assert all(float(mixer[k].abs().min()) > 0 for k in ("bq", "bk", "bv"))
    with_b, _ = M.forward_prefill(cfg, tp, torch.from_numpy(tok))
    zeroed = {**tp, "blocks": {"s0": {**tp["blocks"]["s0"], "mixer": {
        k: torch.zeros_like(v) if k in ("bq", "bk", "bv") else v
        for k, v in mixer.items()}}}}
    without, _ = M.forward_prefill(cfg, zeroed, torch.from_numpy(tok))
    V = cfg.vocab_size
    assert _err(_t(without)[:, :V], _t(with_b)[:, :V]) > 1e-2


# ------------------------------------------------ how the bounds were set --

def _measure(seeds=range(8), archs=NEW_ARCHS, modes=(("f32", False),
                                                       ("bf16", False),
                                                       ("bf16", True)),
             fixed_routing=False):
    """Largest normwise error of the port against JAX (compiled, or op by
    op for ``eager``) per arch, dtype and quantity over ``seeds`` (each
    seed draws its own parameters and tokens), the routers zeroed for
    ``fixed_routing``."""
    worst = {}
    for arch in archs:
        cfg = reduced_config(arch)
        V = cfg.vocab_size
        for dtype, eager in modes:
            w = worst.setdefault((arch, dtype, eager), [0.0, 0.0, 0.0])
            for seed in seeds:
                jp = _jparams(arch, dtype, seed, fixed_routing)
                tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
                tok, nxt = _tokens(100 + seed), _tokens(200 + seed, S=1)
                lj, cj, sj, nj = _jax_run(arch, jp, tok, nxt, eager)
                lt, ct = M.forward_prefill(cfg, tp, torch.from_numpy(tok))
                w[0] = max(w[0], _err(_t(lt)[:, :V], _np(lj)[:, :V]))
                for (_, a), (_, t) in zip(_leaves(jax.tree.map(_np, cj)),
                                          _leaves(ct)):
                    w[1] = max(w[1], _err(_t(t), a))
                st, dt = M.forward_decode(
                    cfg, tp, torch.from_numpy(nxt), S_PRE,
                    params_from_jax(jax.tree.map(np.asarray, cj), "cpu"))
                w[2] = max(w[2], _err(_t(st)[:, :V], _np(sj)[:, :V]))
                for (_, a), (_, t) in zip(_leaves(jax.tree.map(_np, nj)),
                                          _leaves(dt)):
                    w[2] = max(w[2], _err(_t(t), a))
            print(arch, dtype, "eager" if eager else "jit",
                  "logits %.2e cache %.2e decode %.2e" % tuple(w),
                  flush=True)
    return worst


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_archs.py: the measurements
    # behind F32_FRAC and BF16_FRAC; --fixed: Jamba with its routers
    # zeroed (tests/test_torch_archs_bf16.py)
    import sys
    torch.set_num_threads(4)
    if "--fixed" in sys.argv:
        _measure(archs=[JAMBA], modes=(("f32", False), ("bf16", True)),
                 fixed_routing=True)
    else:
        _measure(modes=(("bf16", True),) if "--eager" in sys.argv else
                 (("f32", False), ("bf16", False), ("bf16", True)))
