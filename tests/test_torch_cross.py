"""Llama-3.2-Vision's cross-attention layers in the port against the JAX
package on the CPU, at ``reduced_config("llama-3.2-vision-90b")``: two
scan blocks of five layers (d_model 64, 4 heads over 2 KV heads of 16),
so that layers 4 and 9 cross-attend to 16 image embeddings (the stand-in
for the vision tower, a stub in both packages).

The checks, helpers and tolerances are ``tests/test_torch_encdec.py``'s
(its docstring gives them); the decoder runs 20 tokens, so a self layer's
cache (20 long) and a cross layer's (16 image tokens) differ in shape.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.reduced import reduced_config as jreduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_encdec import (B, DT, F32_FRAC, KERNEL_FRAC, S, decode_case,
                               defs_case, err, frac, grads_case, inputs,
                               jparams, kernel_path_case, make_runs, np32,
                               params_case, prefill_case,
                               prefill_decode_case, rel, t32, train_case,
                               train_step_case)

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"


@pytest.fixture(scope="module")
def runs():
    return make_runs(ARCH)


def test_config_is_jaxs_and_full_width_counts():
    """Every fifth layer (4, 9, ...) cross-attends to 6400 image tokens
    with 64 heads over 8 KV heads of 128; 87.7 B parameters in all, JAX's
    count; one block of five layers at full width 6.39 B, embed and
    unembed 1.06 B each (what chip_smoke.py's phase 13 holds on the
    card)."""
    cfg = reduced_config(ARCH)
    assert cfg.num_layers == 10 and cfg.block_period == 5
    assert [l for l in range(10) if cfg.layer_kind(l) == "cross"] == [4, 9]
    big = get_config(ARCH)
    assert dataclasses.asdict(big) == dataclasses.asdict(jget_config(ARCH))
    assert (big.num_heads, big.num_kv_heads, big.head_dim,
            big.num_image_tokens) == (64, 8, 128, 6400)
    n = M.count_model_params(big)
    assert n == JM.count_model_params(jget_config(ARCH))
    assert 87.6e9 < n < 87.8e9
    one = dataclasses.replace(big, num_layers=5)
    assert 6.38e9 < M.count_model_params(one) < 6.40e9
    assert M.cache_shapes(one, 2, 4096)["blocks"]["s4"] == \
        {"k": (1, 2, 6400, 8, 128), "v": (1, 2, 6400, 8, 128)}
    defs = M.model_defs(big)
    assert set(defs["blocks"]["s4"]) == {"norm1", "mixer", "norm2", "ffn"}
    assert "bq" not in defs["blocks"]["s4"]["mixer"]


def test_model_defs_match_jax():
    defs_case(ARCH)


def test_params_cross_bit_for_bit():
    params_case(ARCH)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_matches_jax(dtype):
    """One cross layer's ``cross_kv`` and ``cross_attention`` (q without
    rope, GQA over the image K/V, nothing masked) against JAX's on the
    same inputs: the plain path within the file's bounds, the kernel call
    site (its plain version here) within them in f32 and within
    KERNEL_FRAC of the plain path in bf16."""
    cfg, jcfg = reduced_config(ARCH), jreduced(ARCH)
    jp, tp = jparams(ARCH, dtype, 6)
    jm = jax.tree.map(lambda a: a[1], jp["blocks"]["s4"]["mixer"])
    tm = {k: v[1] for k, v in tp["blocks"]["s4"]["mixer"].items()}
    b = inputs(ARCH, dtype, 6)
    x = np.random.default_rng(8).standard_normal((B, S, 64)) \
        .astype(np.float32)
    xt = torch.from_numpy(x).to(DT[dtype][0])
    xj = jnp.asarray(x).astype(DT[dtype][1])
    et = torch.from_numpy(b["img_embeds"]).to(DT[dtype][0])
    ej = jnp.asarray(b["img_embeds"]).astype(DT[dtype][1])

    def jrun(m, x, e):
        kv = JL.cross_kv(jcfg, m, e)
        return kv, JL.cross_attention(jcfg, m, x, kv)
    if dtype == "bf16":
        with jax.disable_jit():
            kvj, yj = jrun(jm, xj, ej)
    else:
        kvj, yj = jax.jit(jrun)(jm, xj, ej)
    kv = L.cross_kv(cfg, tm, et)
    for k in ("k", "v"):
        assert kv[k].shape == (B, 16, 2, 16) and kv[k].dtype == DT[dtype][0]
        assert err(t32(kv[k]), np32(kvj[k])) <= frac(dtype, "cache")
    plain = L.cross_attention(cfg, tm, xt, kv, use_kernel=False)
    assert plain.shape == (B, S, 64) and plain.dtype == DT[dtype][0]
    assert err(t32(plain), np32(yj)) <= frac(dtype, "logits")
    got = L.cross_attention(cfg, tm, xt, kv, use_kernel=True)
    if dtype == "f32":
        assert err(t32(got), np32(yj)) <= F32_FRAC
    else:
        assert rel(t32(got), t32(plain)) <= KERNEL_FRAC[ARCH]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_train_matches_jax(runs, dtype):
    train_case(runs, ARCH, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_prefill_matches_jax(runs, dtype):
    caches = prefill_case(runs, ARCH, dtype)
    # a cross layer keeps the image's K/V, a self layer the tokens'
    assert caches["blocks"]["s4"]["k"].shape == (2, B, 16, 2, 16)
    assert caches["blocks"]["s0"]["k"].shape == (2, B, S, 2, 16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_decode_matches_jax(runs, dtype):
    deltas = decode_case(runs, ARCH, dtype)
    assert deltas["blocks"]["s4"] == {}
    assert set(deltas["blocks"]["s3"]) == {"k", "v"}


def test_loss_and_gradients_match_jax():
    grads_case(ARCH)


@pytest.mark.parametrize("use_kernel", [None, True])
def test_prefill_then_decode_equals_forward_train(runs, use_kernel):
    prefill_decode_case(runs, ARCH, use_kernel)


def test_kernel_path_within_its_bound_of_the_plain_path():
    kernel_path_case(ARCH)


def test_train_and_prefill_steps_take_the_embeddings():
    train_step_case(ARCH)
