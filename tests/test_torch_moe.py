"""The port's MoE (``repro_torch.models.layers.moe``: routing, capacity
dispatch, experts, combine, shared experts, aux loss) against the JAX
package's ``moe`` on the CPU, at the MoE of ``reduced_config`` of
``deepseek-v2-lite-16b`` (4 experts, top-2, 2 shared, capacity factor
2.0) and ``mixtral-8x7b`` (4 experts, top-2, no shared expert).

Parameters are drawn by the JAX package's ``init_params`` (the router in
float32, as its ``ParamDef`` says) and carried across bit for bit;
inputs are drawn with numpy from a seed.

- The routing is compared for **equality**: the top-K experts of every
  token (JAX's ``lax.top_k`` output, recorded while JAX's ``moe`` runs)
  and the (E, C, D) dispatch buffer JAX's experts read (which fixes every
  kept entry's slot and, with it, ``keep`` and ``slot``). The inputs are
  checked to have no near-tie between a token's K-th and (K+1)-th
  router probability (margin > 1e-4 against fp32 noise of ~1e-7), so
  the equality is not luck.
- ``f32`` (everything cast to fp32): outputs within atol 1e-5, rtol 1e-4
  (fp32 sum order only); the aux loss within rtol 1e-6.
- ``bf16``, as the model runs: one bf16 rounding (h = silu(g) u) can
  flip between the packages, so outputs are held normwise, max |port -
  jax| <= 4e-3 max |jax| (~4x the largest measured, 1.05e-3, over 10
  seeds of the dropless and the dropping case of both configs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.models import layers as JL
from repro.models.params import init_params as jinit
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.params import init_params

torch.set_num_threads(1)

ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x7b"]
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                     jnp.bfloat16)}
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_FRAC = 4e-3
MARGIN = 1e-4


def _cfgs(arch, **change):
    return (dataclasses.replace(reduced_config(arch), **change),
            dataclasses.replace(jreduced(arch), **change))


def _params(jcfg, dtype, seed=0):
    """One MoE parameter tree in both packages; ``f32`` casts every leaf
    to fp32, ``bf16`` keeps the defs' dtypes (the router fp32)."""
    jp = jinit(JL.moe_defs(jcfg), jax.random.key(seed))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
    j = jnp.asarray(a).astype(DT[dtype][1])
    return torch.from_numpy(np.array(j.astype(jnp.float32))) \
        .to(DT[dtype][0]), j


def _jax_moe(jcfg, jp, xj, monkeypatch):
    """JAX's ``moe`` op by op, recording its top-K and its dispatch
    buffer (the first operand of its first expert product)."""
    seen = {}
    real_top_k, real_einsum = jax.lax.top_k, jnp.einsum

    def top_k(x, k):
        seen["w"], seen["idx"] = real_top_k(x, k)
        return seen["w"], seen["idx"]

    def einsum(eq, *ops, **kw):
        if eq == "ecd,edf->ecf" and "xe" not in seen:
            seen["xe"] = ops[0]
        return real_einsum(eq, *ops, **kw)

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(jnp, "einsum", einsum)
    with jax.disable_jit():
        out, aux = JL.moe(jcfg, jp, xj, return_aux=True)
    monkeypatch.undo()
    return np.asarray(out.astype(jnp.float32)), float(aux), seen


def _dispatch(cfg, r, xt):
    """The port's (E, C, D) dispatch buffer from its routing."""
    E, C, D = cfg.num_experts, r["C"], xt.shape[1]
    tok = torch.arange(xt.shape[0]).repeat_interleave(cfg.experts_per_token)
    buf = xt.new_zeros((E * C + 1, D)).index_put((r["slot"],), xt[tok])
    return buf[:E * C].reshape(E, C, D)


def _no_near_tie(probs, K):
    top = torch.sort(probs, dim=-1, descending=True).values
    return float((top[:, K - 1] - top[:, K]).min()) > MARGIN


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_FRAC * np.abs(want).max()


def _check_routing(cfg, tp, xt, seen):
    """Equal top-K experts and dispatch buffer (so equal keep/slot)."""
    r = L.moe_route(cfg, tp["router"], xt.reshape(-1, cfg.d_model))
    assert _no_near_tie(r["probs"], cfg.experts_per_token)
    np.testing.assert_array_equal(r["idx"].numpy(), np.asarray(seen["idx"]))
    xe = _dispatch(cfg, r, xt.reshape(-1, cfg.d_model))
    assert tuple(xe.shape) == seen["xe"].shape
    np.testing.assert_array_equal(
        xe.float().numpy(), np.asarray(seen["xe"].astype(jnp.float32)))
    return r


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, dtype, monkeypatch):
    cfg, jcfg = _cfgs(arch)
    tp, jp = _params(jcfg, dtype)
    assert tp["router"].dtype == torch.float32
    assert ("shared" in tp) == (arch == "deepseek-v2-lite-16b")
    xt, xj = _x((2, 16, cfg.d_model), dtype, 1)
    want, jaux, seen = _jax_moe(jcfg, jp, xj, monkeypatch)
    r = _check_routing(cfg, tp, xt, seen)
    assert bool(r["keep"].all())          # capacity factor E / K: dropless
    out, aux = L.moe(cfg, tp, xt)
    assert out.dtype == DT[dtype][0] and tuple(out.shape) == want.shape
    _close(out.float().numpy(), want, dtype)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)
    assert torch.equal(L.moe(cfg, tp, xt)[0], out)   # call to call


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_over_capacity_as_jax(arch, dtype, monkeypatch):
    """Capacity factor 1.0: C = T K / E, and the entries of a crowded
    expert past C (in token order) are dropped alike."""
    cfg, jcfg = _cfgs(arch, capacity_factor=1.0)
    tp, jp = _params(jcfg, dtype, seed=2)
    xt, xj = _x((2, 20, cfg.d_model), dtype, 3)
    want, jaux, seen = _jax_moe(jcfg, jp, xj, monkeypatch)
    r = _check_routing(cfg, tp, xt, seen)
    assert r["C"] == 20 and not bool(r["keep"].all())
    out, aux = L.moe(cfg, tp, xt)
    _close(out.float().numpy(), want, dtype)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)


@pytest.mark.parametrize("T,K,E,cf,C", [(40, 2, 4, 1.25, 25),
                                        (4, 6, 64, 1.25, 1),
                                        (16384, 6, 64, 1.25, 1920),
                                        (16380, 6, 64, 1.25, 1920),
                                        (7, 2, 8, 2.0, 4), (3, 2, 16, 1.0, 1),
                                        (32, 2, 4, 2.0, 32)])
def test_capacity_is_jax_arithmetic(T, K, E, cf, C):
    """C = max(ceil(T K cf / E), 1) in Python floats, as JAX computes it:
    DeepSeek's decode step (T 4) gets C = 1, its 4 x 4096 prefill 1920."""
    cfg = dataclasses.replace(reduced_config("mixtral-8x7b"), num_experts=E,
                              experts_per_token=K, capacity_factor=cf)
    jcfg = dataclasses.replace(jreduced("mixtral-8x7b"), num_experts=E,
                               experts_per_token=K, capacity_factor=cf)
    assert L.moe_capacity(cfg, T) == C
    xt = torch.zeros((T, cfg.d_model))
    r = L.moe_route(cfg, torch.zeros((cfg.d_model, E)), xt)
    assert r["C"] == C and tuple(r["idx"].shape) == (T, K)
    assert jcfg.capacity_factor == cfg.capacity_factor


@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_router_ties_go_to_the_lowest_expert(cf, monkeypatch):
    """A zero router gives every expert the same probability: both
    packages pick experts 0 .. K-1 for every token, and at capacity
    factor 1.0 the later tokens' entries are the ones dropped."""
    cfg, jcfg = _cfgs("mixtral-8x7b", capacity_factor=cf)
    tp, jp = _params(jcfg, "f32", seed=4)
    tp["router"] = torch.zeros_like(tp["router"])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    xt, xj = _x((1, 12, cfg.d_model), "f32", 5)
    want, _, seen = _jax_moe(jcfg, jp, xj, monkeypatch)
    r = L.moe_route(cfg, tp["router"], xt.reshape(-1, cfg.d_model))
    K = cfg.experts_per_token
    assert r["idx"].tolist() == [list(range(K))] * 12
    np.testing.assert_array_equal(r["idx"].numpy(), np.asarray(seen["idx"]))
    np.testing.assert_array_equal(
        _dispatch(cfg, r, xt.reshape(-1, cfg.d_model)).numpy(),
        np.asarray(seen["xe"]))
    kept = r["keep"].reshape(12, K)
    n_kept = 12 if cf == 2.0 else 6
    assert kept[:n_kept].all() and not kept[n_kept:].any()
    _close(L.moe(cfg, tp, xt)[0].numpy(), want, "f32")


@pytest.mark.parametrize("K", [1, 2, 6])
def test_combine_equals_jax_scatter_add(K):
    """The in-order K combine is JAX's ``.at[tok_ids].add`` bit for bit
    (fp32, values of mixed magnitude so the order shows)."""
    T, D = 37, 24
    rng = np.random.default_rng(K)
    c = (rng.standard_normal((T * K, D))
         * 10.0 ** rng.integers(-4, 4, (T * K, D))).astype(np.float32)
    tok = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    want = np.asarray(jnp.zeros((T, D), jnp.float32).at[tok].add(
        jnp.asarray(c)))
    got = L.moe_combine(torch.from_numpy(c), K).numpy()
    np.testing.assert_array_equal(got, want)


def test_shared_experts_add_the_dense_mlp():
    """DeepSeek's shared experts are one MLP of width moe_d_ff x 2, added
    to the routed sum in fp32: the output minus the routed-only output
    (the same tree without ``shared``) is that MLP's output (f32)."""
    cfg, jcfg = _cfgs("deepseek-v2-lite-16b")
    tp, _ = _params(jcfg, "f32", seed=6)
    assert tuple(tp["shared"]["wg"].shape) == (64, 128)
    xt, _ = _x((2, 8, cfg.d_model), "f32", 7)
    routed, _ = L.moe(dataclasses.replace(cfg, num_shared_experts=0), tp,
                      xt)
    shared = L.mlp(cfg, tp["shared"], xt)
    torch.testing.assert_close(L.moe(cfg, tp, xt)[0], routed + shared,
                               atol=1e-6, rtol=1e-6)


def test_aux_loss_is_switch_style():
    """aux = E * sum_e mean_t(probs[t, e]) * (entries routed to e) / (T K),
    counted over every top-K entry, dropped ones included."""
    cfg, jcfg = _cfgs("mixtral-8x7b", capacity_factor=1.0)
    tp, _ = _params(jcfg, "f32", seed=8)
    xt, _ = _x((3, 10, cfg.d_model), "f32", 9)
    _, aux = L.moe(cfg, tp, xt)
    r = L.moe_route(cfg, tp["router"], xt.reshape(-1, cfg.d_model))
    E, TK = cfg.num_experts, r["flat_e"].numel()
    counts = torch.bincount(r["flat_e"], minlength=E)
    assert torch.equal(r["counts"], counts)
    load = counts.float() / TK
    assert not bool(r["keep"].all())
    torch.testing.assert_close(aux, E * (r["probs"].mean(0) * load).sum(),
                               atol=0, rtol=0)


def test_init_params_keeps_the_router_fp32():
    """``init_params`` honours a ``ParamDef``'s dtype: the router is
    float32 (JAX's ``moe_defs``), the experts bf16."""
    cfg = reduced_config("deepseek-v2-lite-16b")
    p = init_params(L.moe_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    assert p["router"].dtype == torch.float32
    assert all(p[k].dtype == torch.bfloat16 for k in ("wg", "wu", "wd"))
    assert p["shared"]["wg"].dtype == torch.bfloat16
    std = float(p["router"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.2 / np.sqrt(cfg.d_model)
