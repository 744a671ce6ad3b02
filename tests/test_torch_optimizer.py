"""The port's AdamW (``repro_torch.training.optimizer``) against the JAX
package's on the CPU, on the same numpy inputs.

JAX computes every scalar in fp32 (its Python floats are weakly typed),
and so does the port (0-d fp32 tensors). The one difference left is the
fp32 ``cos`` of the schedule and XLA's fused multiply-adds in the
compiled update, which move ``lr``, m and v by at most an ulp or two:
- ``schedule``: rtol 3e-7 (two fp32 ulps at most; JAX's own compiled and
  op-by-op schedules differ by as much at 8 of 60 steps);
- ``adamw_update``: ``lr`` within the schedule's rtol; the global norm within rtol
  1e-6 (fp32 sums of a leaf in another order: an ulp, which moves the
  clip scale by one, two in v's g²); m and v within rtol 6e-7 (measured
  3.2e-7) and fp32 parameters within 3e-7 of their leaf's largest value
  (that ulp, and XLA contracting ``p - lr * upd`` and
  ``b * m + (1 - b) * g`` into fused multiply-adds; measured: at most
  2.5e-8, in 6 of ~180 fp32 parameters); bf16 parameters bit for bit on these inputs (an ulp of
  the fp32 update could flip a bf16 rounding; it does not here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.training import optimizer as O
from repro_torch.tree import flatten, paths

SCHED_RTOL = 3e-7
STATE_RTOL = 6e-7       # m and v, elementwise
PARAM_TOL = 3e-7        # fp32 parameters, of their leaf's largest value

CONFIGS = [dict(), dict(lr=1e-3, warmup_steps=5, total_steps=40,
                        weight_decay=0.01),
           dict(lr=0.01, warmup_steps=3, total_steps=1000, min_lr_frac=0.3,
                beta1=0.8, beta2=0.99, clip_norm=0.5),
           dict(warmup_steps=0, total_steps=1)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_schedule_matches_jax(kw):
    jo, to = JO.OptConfig(**kw), O.OptConfig(**kw)
    steps = np.arange(0, 1300, 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: JO.schedule(jo, s)))(
        jnp.asarray(steps)))
    got = np.array([float(O.schedule(to, torch.tensor(int(s),
                                                      dtype=torch.int32)))
                    for s in steps], np.float32)
    assert O.schedule(to, torch.tensor(3, dtype=torch.int32)).dtype \
        == torch.float32
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    assert (got == want).mean() > 0.5


def _tree(rng):
    """bf16 and fp32 leaves, under names the decay mask skips (A_log,
    norm weights, dt_bias, a bias "b") and names it decays."""
    bf = lambda *s: rng.standard_normal(s).astype(jnp.bfloat16)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"blocks": {"s0": {"mixer": {"A_log": f32(2, 4),
                                        "dt_bias": bf(2, 4),
                                        "w_x": bf(2, 8, 4, 2),
                                        "w_out": f32(2, 4, 2, 8)},
                              "norm1": {"w": bf(2, 8)},
                              "ffn": {"b1": f32(2, 16), "w1": bf(2, 8, 16)}}},
            "embed": bf(32, 8), "final_norm": {"w": f32(8), "b": bf(8)}}


_jax_update = jax.jit(JO.adamw_update, static_argnums=3)


def _jax_step(oc, p, g, s):
    return _jax_update(p, g, s, oc)


@pytest.mark.parametrize("kw", CONFIGS[:3])
@pytest.mark.parametrize("start", [0, 4])
def test_adamw_update_matches_jax(kw, start):
    rng = np.random.default_rng(start + len(kw))
    params = _tree(rng)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3)
                         .astype(p.dtype), params)
    jo, to = JO.OptConfig(**kw), O.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(jnp.asarray, grads)
    state = JO.init_opt_state(jp, jo)
    for _ in range(start):       # a later state: JAX's own steps
        _, state, _ = _jax_step(jo, jp, jg, state)
    want_p, want_s, want_m = _jax_step(jo, jp, jg, state)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    got_p, got_s, got_m = O.adamw_update(
        params_from_jax(np_(jp), "cpu"), params_from_jax(np_(jg), "cpu"),
        opt_state_from_jax(np_(state), "cpu"), to)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=SCHED_RTOL)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    assert int(got_s["step"]) == int(want_s["step"]) == start + 1
    assert got_s["step"].dtype == torch.int32
    for a, b in zip(flatten(got_p), jax.tree.leaves(want_p)):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[1] == b.dtype.name
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.float().numpy(), b.astype(np.float32))
        else:   # normwise: where p - lr * upd cancels, an ulp of the
            # product is large against the result
            assert np.abs(a.numpy() - b).max() <= PARAM_TOL * np.abs(b).max()
    for a, b in zip(flatten(got_s["m"]) + flatten(got_s["v"]),
                    jax.tree.leaves(want_s["m"])
                    + jax.tree.leaves(want_s["v"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=STATE_RTOL, atol=0)


def test_decay_mask_matches_jax():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    tree["x"] = {n: np.zeros(1, np.float32) for n in (
        "w", "b", "bq", "bk", "bv", "b1", "b2", "dt_bias", "A_log", "D_skip",
        "norm", "kv_norm", "wq", "wo", "w_z", "conv_x", "unembed")}
    want = [JO._decay_mask(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = [O._decay_mask(p) for p in paths(tree)]
    assert got == want
    assert True in got and False in got


def test_global_norm_and_state_dtypes():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = O.global_norm(params_from_jax(tree, "cpu"))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    tp = params_from_jax(tree, "cpu")
    for dt in (torch.float32, torch.bfloat16):
        st = O.init_opt_state(tp, O.OptConfig(state_dtype=dt))
        assert sorted(st) == ["m", "step", "v"]
        assert st["step"].dtype == torch.int32 and st["step"].shape == ()
        for m, p in zip(flatten(st["m"]), flatten(tp)):
            assert m.dtype == dt and m.shape == p.shape and not m.any()
    jst = JO.init_opt_state(jax.tree.map(jnp.asarray, tree), JO.OptConfig())
    cst = opt_state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    for a, b in zip(flatten(cst), flatten(O.init_opt_state(tp,
                                                           O.OptConfig()))):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_bf16_state_dtype_matches_jax():
    """``state_dtype=bfloat16`` stores m and v rounded to bf16, as JAX."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                         .astype(p.dtype), params)
    jo = JO.OptConfig(state_dtype=jnp.bfloat16)
    to = O.OptConfig(state_dtype=torch.bfloat16)
    jp, jg = (jax.tree.map(jnp.asarray, t) for t in (params, grads))
    _, want, _ = _jax_step(jo, jp, jg, JO.init_opt_state(jp, jo))
    tp = params_from_jax(params, "cpu")
    _, got, _ = O.adamw_update(tp, params_from_jax(grads, "cpu"),
                               O.init_opt_state(tp, to), to)
    for a, b in zip(flatten(got["m"]) + flatten(got["v"]),
                    jax.tree.leaves(want["m"]) + jax.tree.leaves(want["v"])):
        assert a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b).astype(np.float32)
        # the fp32 values agree within rtol 3e-7 and round to bf16 alike
        # but where one straddles a rounding boundary: one bf16 ulp
        assert (a == b).mean() > 0.99
        np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0)
