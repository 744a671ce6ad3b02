"""Whisper-small's encoder-decoder in the port against the JAX package on
the CPU, at ``reduced_config("whisper-small")`` (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16, layernorm, tanh-GELU MLP with biases,
24 encoder frames), and the serve's refusal of both the encoder-decoder
and the cross-attention model (``tests/test_torch_cross.py`` runs the
same checks on Llama-3.2-Vision with this file's helpers).

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit (``params_from_jax``); tokens, labels and the
encoder's frame embeddings (the stand-in for Whisper's conv front end,
a stub in both packages) are drawn with numpy from a seed. The decoder
runs 20 tokens, so that its self-attention caches (20 long) and its
cross-attention caches (24 frames) differ in shape. JAX runs compiled in
``f32`` and op by op in ``bf16`` (compiled bf16 JAX skips roundings the
port takes; ``tests/test_torch_archs.py``).

Tolerances, ``tests/test_torch_archs.py``'s and
``tests/test_torch_train.py``'s, normwise ``max |port - jax| <= frac *
max |jax|`` unless stated:
- ``f32``: 1e-5 on logits, caches, decode steps and the encoder's
  output; the loss rtol 1e-6 and each gradient leaf 1e-4;
- ``bf16``: 2e-2 on prefill logits, caches and ``forward_train``'s
  logits; 1e-5 on the decode step from JAX's caches; the loss rtol 5e-4,
  and each gradient leaf (relative RMS) at most 4x as far from JAX's
  fp32 gradient as JAX's own bf16 gradient is, plus 1e-3.
``python tests/test_torch_encdec.py`` prints the largest errors over 8
seeds behind these bounds, and ``--kernel-path`` the kernel path's
distance from the plain path behind ``KERNEL_FRAC`` and
``chip_smoke.py``'s ``WHISPER_TOL``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models.params import init_params as jinit
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import ParamDef, leaves
from repro_torch.training import step as ST
from repro_torch.tree import flatten

torch.set_num_threads(1)

ARCH = "whisper-small"
B, S = 2, 20
F32_FRAC = 1e-5
BF16_FRAC = dict(logits=2e-2, cache=2e-2, decode=1e-5)
GRAD_TOL = dict(f32_loss=1e-6, f32_grad=1e-4, bf16_loss=5e-4, ratio=4.0,
                floor=1e-3)
# the kernel path (use_kernel=True: on the CPU the kernel's plain
# version, which takes p.V in fp32) against the plain path
# (blockwise_attention, which rounds p to bf16) in bf16, last-token
# logits, relative RMS: ~4x the largest of 8 seeds (--kernel-path)
# (measured 9.8e-3 and 1.8e-2)
KERNEL_FRAC = {"whisper-small": 4e-2, "llama-3.2-vision-90b": 7e-2}
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


# ------------------------------------------------------------ helpers ------

@functools.lru_cache(maxsize=None)
def _jinit(arch, seed):
    return jinit(JM.model_defs(jreduced(arch)), jax.random.key(seed))


def jparams(arch, dtype, seed=0):
    """JAX's parameter tree of the reduced arch (every leaf fp32 for
    ``f32``) and the port's copy of it."""
    jp = _jinit(arch, seed)
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def inputs(arch, dtype, seed, s=S, masked=True):
    """numpy batch: tokens (B, s), labels (the next tokens, the first 3
    of row 0 masked unless ``masked=False``), and the encoder's or the image's embeddings (B,
    frames, D), standard normal, in the dtype's precision (fp32 arrays
    holding bf16 values for ``bf16``)."""
    cfg = reduced_config(arch)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    if masked:
        labels[0, :3] = -1
    out = {"tokens": tok[:, :-1], "labels": labels}
    key, n = (("enc_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder
              else ("img_embeds", cfg.num_image_tokens))
    e = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    if dtype == "bf16":
        e = np.array(jnp.asarray(e).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    out[key] = e
    return out


def embeds_kw(batch, dtype, to="torch"):
    """The batch's encoder or image embeddings as keyword arguments, in
    the dtype, as torch tensors or JAX arrays."""
    out = {}
    for k in ("enc_embeds", "img_embeds"):
        if k in batch:
            if to == "torch":
                out[k] = torch.from_numpy(batch[k]).to(DT[dtype][0])
            else:
                out[k] = jnp.asarray(batch[k]).astype(DT[dtype][1])
    return out


def tbatch(batch, dtype):
    """The whole batch as torch tensors, embeddings in the dtype."""
    return {**{k: torch.from_numpy(v) for k, v in batch.items()},
            **embeds_kw(batch, dtype)}


def jbatch(batch, dtype):
    return {**{k: jnp.asarray(v) for k, v in batch.items()},
            **embeds_kw(batch, dtype, "jax")}


def np32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def t32(t):
    return t.detach().float().numpy()


def err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def jax_run(arch, jp, batch, dtype):
    """JAX's prefill of the batch's tokens, one decode step of ``nxt``
    from its caches, and forward_train's logits: compiled in ``f32``, op
    by op in ``bf16``."""
    jcfg = jreduced(arch)

    def run(p, b):
        kw = {k: b[k] for k in ("enc_embeds", "img_embeds") if k in b}
        logits, caches = JM.forward_prefill(jcfg, p, b["tokens"], **kw)
        step, deltas = JM.forward_decode(jcfg, p, b["nxt"],
                                         b["tokens"].shape[1], caches)
        train, _ = JM.forward_train(jcfg, p, b["tokens"], **kw)
        return logits, caches, step, deltas, train

    jb = jbatch(batch, dtype)
    if dtype == "bf16":
        with jax.disable_jit():
            return run(jp, jb)
    return jax.jit(run)(jp, jb)


def make_runs(arch):
    """dtype -> (port params, JAX params, batch, JAX's results), each
    computed once."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jp, tp = jparams(arch, dtype)
            batch = inputs(arch, dtype, 4)
            batch["nxt"] = np.random.default_rng(5).integers(
                0, reduced_config(arch).vocab_size, (B, 1)).astype(np.int32)
            cache[dtype] = (tp, jp, batch, jax_run(arch, jp, batch, dtype))
        return cache[dtype]
    return get


def frac(dtype, what):
    return F32_FRAC if dtype == "f32" else BF16_FRAC[what]


# ------------------------------------------------- checks for both archs ---

def defs_case(arch):
    """``model_defs``: every key, shape, dtype and init of JAX's; the
    parameter counts and ``cache_shapes`` equal."""
    cfg, jcfg = reduced_config(arch), jreduced(arch)
    td, jd = leaves(M.model_defs(cfg)), tree_leaves(JM.model_defs(jcfg))
    assert [k for k, _ in td] == [k.lstrip("/") for k, _ in jd]
    for (_, t), (_, j) in zip(td, jd):
        assert isinstance(t, ParamDef)
        assert (t.shape, t.axes, t.init, t.fan_in) == \
            (j.shape, j.axes, j.init, j.fan_in)
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
    assert M.count_model_params(cfg) == JM.count_model_params(jcfg)
    assert M.active_params(cfg) == JM.active_params(jcfg)
    assert M.cache_shapes(cfg, B, S) == JM.cache_shapes(jcfg, B, S)


def params_case(arch):
    """``params_from_jax`` carries the whole tree, the encoder's and the
    cross layers' leaves included, bit for bit: no change was needed."""
    jp, tp = jparams(arch, "bf16")
    jl = tree_leaves(jax.tree.map(np.asarray, jp))
    tl = tree_leaves(tp)
    assert [k for k, _ in jl] == [k for k, _ in tl]
    assert [k for k, _ in tl] == [
        "/" + k for k, _ in leaves(M.model_defs(reduced_config(arch)))]
    for (_, a), (_, t) in zip(jl, tl):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


def train_case(runs, arch, dtype):
    """``forward_train``'s logits over the whole sequence."""
    cfg = reduced_config(arch)
    tp, _, batch, (_, _, _, _, trj) = runs(dtype)
    logits, aux = M.forward_train(cfg, tp, torch.from_numpy(batch["tokens"]),
                                  **embeds_kw(batch, dtype))
    V = cfg.vocab_size
    assert logits.shape == (B, S, cfg.padded_vocab())
    assert float(aux) == 0.0
    assert err(t32(logits)[..., :V], np32(trj)[..., :V]) \
        <= frac(dtype, "logits")


def prefill_case(runs, arch, dtype):
    """``forward_prefill``'s last logits and every cache leaf, the tree
    key for key JAX's and ``cache_shapes``'."""
    cfg = reduced_config(arch)
    tp, _, batch, (lj, cj, _, _, _) = runs(dtype)
    logits, caches = M.forward_prefill(cfg, tp,
                                       torch.from_numpy(batch["tokens"]),
                                       **embeds_kw(batch, dtype))
    V = cfg.vocab_size
    assert bool((logits[:, V:] == -1e9).all())
    assert err(t32(logits)[:, :V], np32(lj)[:, :V]) <= frac(dtype, "logits")
    shapes = dict(tree_leaves(M.cache_shapes(cfg, B, S)))
    jl, tl = tree_leaves(jax.tree.map(np32, cj)), tree_leaves(caches)
    assert [k for k, _ in tl] == [k for k, _ in jl] == list(shapes)
    for (k, a), (_, t) in zip(jl, tl):
        assert t.dtype == DT[dtype][0]
        assert tuple(t.shape) == a.shape == shapes[k]
        assert err(t32(t), a) <= frac(dtype, "cache"), k
    return caches


def decode_case(runs, arch, dtype):
    """One ``forward_decode`` step from JAX's prefill caches, carried
    across: its logits, and a delta tree key for key JAX's (no delta of
    the cross-attention K/V)."""
    cfg = reduced_config(arch)
    tp, _, batch, (_, cj, sj, nj, _) = runs(dtype)
    ct = params_from_jax(jax.tree.map(np.asarray, cj), "cpu")
    step, deltas = M.forward_decode(cfg, tp, torch.from_numpy(batch["nxt"]),
                                    S, ct)
    V = cfg.vocab_size
    assert err(t32(step)[:, :V], np32(sj)[:, :V]) <= frac(dtype, "decode")
    assert jax.tree.structure(jax.tree.map(np32, nj)) == \
        jax.tree.structure(jax.tree.map(t32, deltas))
    jl, tl = tree_leaves(jax.tree.map(np32, nj)), tree_leaves(deltas)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (_, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert err(t32(t), a) <= frac(dtype, "decode")
    return deltas


def prefill_decode_case(runs, arch, use_kernel):
    """prefill(S-1) + decode at S-1 == forward_train's last row and
    prefill(S)'s logits (f32), on the plain path and on the kernel call
    sites (their plain versions here)."""
    cfg = reduced_config(arch)
    tp, _, batch, _ = runs("f32")
    tok = torch.from_numpy(batch["tokens"])
    kw = embeds_kw(batch, "f32")
    full, _ = M.forward_prefill(cfg, tp, tok, use_kernel=use_kernel, **kw)
    train, _ = M.forward_train(cfg, tp, tok, **kw)
    _, caches = M.forward_prefill(cfg, tp, tok[:, :-1],
                                  use_kernel=use_kernel, **kw)
    step, _ = M.forward_decode(cfg, tp, tok[:, -1:], S - 1, caches,
                               use_kernel=use_kernel)
    V = cfg.vocab_size
    assert err(t32(step)[:, :V], t32(full)[:, :V]) <= F32_FRAC
    assert err(t32(step)[:, :V], t32(train)[:, -1, :V]) <= F32_FRAC


def jax_grads(arch, jp, batch, dtype):
    cfg = jreduced(arch)
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True))(
        jp, jbatch(batch, dtype))
    return float(loss), [np.asarray(x.astype(jnp.float32))
                         for x in jax.tree.leaves(g)]


def port_grads(arch, tp, batch, dtype):
    cfg = reduced_config(arch)
    loss, _, g = ST.value_and_grad(
        lambda p, b: M.loss_fn(cfg, p, b), tp, tbatch(batch, dtype),
        has_aux=True)
    return float(loss), [t32(x) for x in flatten(g)]


def grads_case(arch):
    """``loss_fn`` (the embeddings read from the batch) and every
    gradient leaf against ``jax.value_and_grad``: f32 within 1e-6 / 1e-4,
    bf16 within rtol 5e-4 and, leaf by leaf, within 4x JAX's own bf16
    distance from its f32 gradient (plus 1e-3) of JAX's f32 gradient."""
    batch = inputs(arch, "bf16", 7)
    jp32, tp32 = jparams(arch, "f32", 7)
    jl32, jg32 = jax_grads(arch, jp32, batch, "f32")
    tl32, tg32 = port_grads(arch, tp32, batch, "f32")
    assert len(tg32) == len(jg32) == len(flatten(tp32))
    assert abs(tl32 - jl32) <= GRAD_TOL["f32_loss"] * abs(jl32)
    for t, j in zip(tg32, jg32):
        assert t.shape == j.shape
        assert err(t, j) <= GRAD_TOL["f32_grad"]
    jp16, tp16 = jparams(arch, "bf16", 7)
    jl16, jg16 = jax_grads(arch, jp16, batch, "bf16")
    tl16, tg16 = port_grads(arch, tp16, batch, "bf16")
    assert abs(tl16 - jl32) <= GRAD_TOL["bf16_loss"] * abs(jl32)
    assert abs(tl16 - jl16) <= GRAD_TOL["bf16_loss"] * abs(jl16)
    for t, j16, j32 in zip(tg16, jg16, jg32):
        assert rel(t, j32) <= GRAD_TOL["ratio"] * rel(j16, j32) \
            + GRAD_TOL["floor"]


def train_step_case(arch):
    """``build_train_step``'s microbatch split covers the embeddings:
    grad_accum 2 takes the same step as grad_accum 1 (f32; no label
    masked, so the microbatches' mean losses average to the batch's),
    and ``build_prefill_step`` passes them on."""
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    cfg = reduced_config(arch)
    _, tp = jparams(arch, "f32", 2)
    b = tbatch(inputs(arch, "f32", 2, masked=False), "f32")
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = []
    for ga in (1, 2):
        step = ST.build_train_step(cfg, oc, grad_accum=ga)
        p, _, m = step(tp, init_opt_state(tp, oc), b)
        out.append((float(m["loss"]), flatten(p)))
    # the updates within chip_smoke's fp32 bound for such variants
    # (TRAIN_CPU_TOL's 5e-4, rel RMS): Adam's first step divides each
    # gradient by its own magnitude, so sum-order noise in a near-zero
    # gradient moves its update
    assert abs(out[0][0] - out[1][0]) <= 1e-6 * abs(out[0][0])
    p0 = flatten(tp)
    for a, c, z in zip(out[0][1], out[1][1], p0):
        assert rel(t32(c) - t32(z), t32(a) - t32(z)) <= 5e-4
    logits, caches = ST.build_prefill_step(cfg)(tp, b)
    want, _ = M.forward_prefill(cfg, tp, b["tokens"], **{
        k: v for k, v in b.items() if k.endswith("embeds")})
    assert torch.equal(logits, want)


def kernel_path_case(arch):
    """The kernel call sites (their plain version, ``attention_ref``,
    here) against ``blockwise_attention`` in bf16: last-token logits
    within KERNEL_FRAC (rel RMS), and no launch counted on the CPU."""
    cfg = reduced_config(arch)
    _, tp = jparams(arch, "bf16", 1)
    batch = inputs(arch, "bf16", 1)
    tok = torch.from_numpy(batch["tokens"])
    kw = embeds_kw(batch, "bf16")
    n = attn_kernel.flash_attention.launches
    lk, _ = M.forward_prefill(cfg, tp, tok, use_kernel=True, **kw)
    lp, _ = M.forward_prefill(cfg, tp, tok, use_kernel=False, **kw)
    assert attn_kernel.flash_attention.launches == n
    V = cfg.vocab_size
    assert rel(t32(lk)[:, :V], t32(lp)[:, :V]) <= KERNEL_FRAC[arch]


# ------------------------------------------------------------- Whisper -----

@pytest.fixture(scope="module")
def runs():
    return make_runs(ARCH)


def test_config_is_jaxs_and_full_width_counts():
    """The reduced config keeps the encoder (2 layers over 24 frames);
    at full width Whisper-small has 12 + 12 layers and JAX's parameter
    count, 0.28 B (vocab 51865 padded to 53248), with a layernorm,
    tanh-GELU MLP with biases, no QKV bias and untied embeddings; every
    decoder layer holds its cross-attention after the mixer."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    cfg = reduced_config(ARCH)
    assert (cfg.encoder_layers, cfg.encoder_seq, cfg.num_layers) == \
        (2, 24, 2)
    big = get_config(ARCH)
    assert dataclasses.asdict(big) == dataclasses.asdict(jget_config(ARCH))
    assert (big.encoder_layers, big.num_layers, big.encoder_seq) == \
        (12, 12, 1500)
    assert big.padded_vocab() == 53248
    assert not big.qkv_bias and not big.tie_embeddings
    assert M.count_model_params(big) == \
        JM.count_model_params(jget_config(ARCH))
    assert 0.27e9 < M.count_model_params(big) < 0.29e9
    defs = M.model_defs(big)
    assert set(defs["encoder"]) == {"blocks", "final_norm"}
    assert list(defs["blocks"]["s0"]) == ["norm1", "mixer", "norm_x",
                                          "xattn", "norm2", "ffn"]
    assert set(defs["blocks"]["s0"]["ffn"]) == {"w1", "b1", "w2", "b2"}
    assert set(defs["blocks"]["s0"]["norm1"]) == {"w", "b"}


def test_model_defs_match_jax():
    defs_case(ARCH)


def test_params_cross_bit_for_bit():
    params_case(ARCH)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_forward_matches_jax(dtype):
    """The encoder's output (non-causal, rope'd self-attention over the
    24 frames, then the encoder's final norm) on the plain path and on
    the kernel call site (its plain version here)."""
    cfg, jcfg = reduced_config(ARCH), jreduced(ARCH)
    jp, tp = jparams(ARCH, dtype, 2)
    e = inputs(ARCH, dtype, 2)["enc_embeds"]
    et = torch.from_numpy(e).to(DT[dtype][0])
    ej = jnp.asarray(e).astype(DT[dtype][1])
    if dtype == "bf16":
        with jax.disable_jit():
            want = JM._encoder_forward(jcfg, jp, ej, None)
    else:
        want = jax.jit(lambda p, x: JM._encoder_forward(jcfg, p, x, None))(
            jp, ej)
    plain = M.encoder_forward(cfg, tp, et, use_kernel=False)
    assert plain.dtype == DT[dtype][0] and plain.shape == (B, 24, 64)
    assert err(t32(plain), np32(want)) <= frac(dtype, "logits")
    got = M.encoder_forward(cfg, tp, et, use_kernel=True)
    if dtype == "f32":
        assert err(t32(got), np32(want)) <= F32_FRAC
    else:     # p.V in fp32 on the kernel path, not rounded to bf16
        assert rel(t32(got), t32(plain)) <= KERNEL_FRAC[ARCH]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_train_matches_jax(runs, dtype):
    train_case(runs, ARCH, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_prefill_matches_jax(runs, dtype):
    caches = prefill_case(runs, ARCH, dtype)
    # the decoder's self-attention K/V are 20 long, the encoder's 24
    assert caches["blocks"]["s0"]["k"].shape == (2, B, S, 2, 16)
    assert caches["blocks"]["s0"]["xk"].shape == (2, B, 24, 2, 16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_decode_matches_jax(runs, dtype):
    deltas = decode_case(runs, ARCH, dtype)
    assert set(deltas["blocks"]["s0"]) == {"k", "v"}


def test_loss_and_gradients_match_jax():
    grads_case(ARCH)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_prefill_then_decode_equals_forward_train(runs, use_kernel):
    prefill_decode_case(runs, ARCH, use_kernel)


def test_kernel_path_within_its_bound_of_the_plain_path():
    kernel_path_case(ARCH)


def test_train_and_prefill_steps_take_the_embeddings():
    train_step_case(ARCH)


def test_missing_inputs_raise():
    """An encoder-decoder without ``enc_embeds`` and a cross-attention
    model without ``img_embeds`` raise, naming what to pass."""
    for arch, what in ((ARCH, "enc_embeds"),
                       ("llama-3.2-vision-90b", "img_embeds")):
        cfg = reduced_config(arch)
        _, tp = jparams(arch, "f32")
        tok = torch.zeros((1, 4), dtype=torch.int64)
        with pytest.raises(ValueError, match=what):
            M.forward_prefill(cfg, tp, tok)
        with pytest.raises(ValueError, match=what):
            M.forward_train(cfg, tp, tok)


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-90b"])
def test_both_serves_refuse(arch):
    """The serve swaps its caches for each step's decode deltas, which
    carry no encoder or image K/V: the JAX package's serve fails on the
    mismatch of its trees, the port's refuses before making weights."""
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--batch-size",
            "2"]
    with pytest.raises(ValueError):
        jserve.main(argv)
    with pytest.raises(ValueError, match="deltas"):
        serve.main(argv + ["--device", "cpu"])


# ------------------------------------------------ how the bounds were set --

def measure(arch, seeds=range(8)):
    """Largest normwise error of the port against JAX per dtype and
    quantity over ``seeds`` (each seed draws parameters and inputs)."""
    cfg = reduced_config(arch)
    V = cfg.vocab_size
    for dtype in ("f32", "bf16"):
        w = dict(logits=0.0, cache=0.0, decode=0.0, train=0.0)
        for seed in seeds:
            jp, tp = jparams(arch, dtype, seed)
            batch = inputs(arch, dtype, 100 + seed)
            batch["nxt"] = inputs(arch, dtype, 200 + seed, s=1)["tokens"]
            lj, cj, sj, nj, trj = jax_run(arch, jp, batch, dtype)
            kw = embeds_kw(batch, dtype)
            tok = torch.from_numpy(batch["tokens"])
            lt, ct = M.forward_prefill(cfg, tp, tok, **kw)
            w["logits"] = max(w["logits"], err(t32(lt)[:, :V],
                                               np32(lj)[:, :V]))
            for (_, a), (_, t) in zip(tree_leaves(jax.tree.map(np32, cj)),
                                      tree_leaves(ct)):
                w["cache"] = max(w["cache"], err(t32(t), a))
            st, dt = M.forward_decode(
                cfg, tp, torch.from_numpy(batch["nxt"]), S,
                params_from_jax(jax.tree.map(np.asarray, cj), "cpu"))
            w["decode"] = max(w["decode"], err(t32(st)[:, :V],
                                               np32(sj)[:, :V]))
            for (_, a), (_, t) in zip(tree_leaves(jax.tree.map(np32, nj)),
                                      tree_leaves(dt)):
                w["decode"] = max(w["decode"], err(t32(t), a))
            tr, _ = M.forward_train(cfg, tp, tok, **kw)
            w["train"] = max(w["train"], err(t32(tr)[..., :V],
                                             np32(trj)[..., :V]))
        print(arch, dtype, w, flush=True)


def measure_kernel_path(arch, seeds=range(8)):
    """Relative RMS of the kernel path (its plain version here) against
    the plain path, bf16, reduced config: last-token logits."""
    cfg = reduced_config(arch)
    V = cfg.vocab_size
    worst = 0.0
    for seed in seeds:
        _, tp = jparams(arch, "bf16", seed)
        batch = inputs(arch, "bf16", 300 + seed)
        tok = torch.from_numpy(batch["tokens"])
        kw = embeds_kw(batch, "bf16")
        lk, _ = M.forward_prefill(cfg, tp, tok, use_kernel=True, **kw)
        lp, _ = M.forward_prefill(cfg, tp, tok, use_kernel=False, **kw)
        worst = max(worst, rel(t32(lk)[:, :V], t32(lp)[:, :V]))
    print(arch, "kernel path vs plain, bf16 logits rel RMS", worst)


def deep_config(arch):
    """The chip's configuration of ``arch`` at narrow width: Whisper-small
    at its full depth (12 + 12 layers), heads (12 of 64) and 1500 frames;
    Llama-3.2-Vision at the chip's depth (one block: 4 self layers, then
    the cross layer), heads (64 over 8 of 128) and 6400 image tokens;
    both with d_model 256, d_ff 512 and vocab 4096. What
    ``chip_smoke.py``'s bounds for phase 13 are measured on."""
    from repro_torch.configs import get_config
    cut = dict(d_model=256, d_ff=512, vocab_size=4096)
    if arch == "llama-3.2-vision-90b":
        cut["num_layers"] = 5
    return dataclasses.replace(get_config(arch), **cut)


def measure_deep_kernel_path(arch, seeds=range(3), Bn=2):
    """The kernel path against the plain path at ``deep_config`` in bf16
    on the CPU (the kernel's plain version), as ``chip_smoke.py`` phase
    13 measures it on the card: attention outputs layer by layer on the
    same inputs and the encoder's output (``_xattn_layers``), last-token
    logits end to end, and prefill(S-1) + decode against the kernel
    path's prefill(S); relative RMS."""
    import importlib.util
    from pathlib import Path
    from repro_torch.models.params import init_params as tinit
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = deep_config(arch)
    Sq = 448 if cfg.is_encoder_decoder else 512
    key, n = (("enc_embeds", cfg.encoder_seq) if cfg.is_encoder_decoder
              else ("img_embeds", cfg.num_image_tokens))
    worst = {}
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        p = tinit(M.model_defs(cfg), gen, "cpu")
        tok = torch.randint(0, cfg.vocab_size, (Bn, Sq), generator=gen)
        emb = torch.randn((Bn, n, cfg.d_model), generator=gen).bfloat16()
        with torch.inference_mode():
            d = smoke._xattn_layers(cfg, p, tok, emb, use_kernel=True)
            kw = {key: emb}
            lk, _ = M.forward_prefill(cfg, p, tok, use_kernel=True, **kw)
            lp, _ = M.forward_prefill(cfg, p, tok, use_kernel=False, **kw)
            _, c = M.forward_prefill(cfg, p, tok[:, :-1], use_kernel=True,
                                     **kw)
            st, _ = M.forward_decode(cfg, p, tok[:, -1:], Sq - 1, c,
                                     use_kernel=True)
        V = cfg.vocab_size
        d["logits"] = rel(t32(lk)[:, :V], t32(lp)[:, :V])
        d["decode_logits"] = rel(t32(st)[:, :V], t32(lk)[:, :V])
        for k, v in d.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(arch, seed, d, flush=True)
    print(arch, "worst", worst, flush=True)
    return worst


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_encdec.py [--kernel-path |
    # --deep]: the measurements behind this file's and
    # tests/test_torch_cross.py's bounds, and chip_smoke.py's
    # WHISPER_TOL / VISION_TOL (--deep)
    import sys
    torch.set_num_threads(4)
    for a in (ARCH, "llama-3.2-vision-90b"):
        if "--deep" in sys.argv:
            measure_deep_kernel_path(a)
        elif "--kernel-path" in sys.argv:
            measure_kernel_path(a)
        else:
            measure(a)
