"""The JAX package's ``models/layers.py``: norms, rope, GQA
self-attention (prefill and decode), cross-attention to precomputed
encoder or image K/V, MLA (DeepSeek's latent attention, prefill and the
absorbed decode), the MLP and the MoE with sort-based capacity dispatch.

The casts follow the JAX package op for op:
- a norm runs in fp32, is rounded to the input's dtype, and only then
  multiplied by the weight, so for bf16 activations the product with
  ``w`` is taken (and rounded) in bf16;
- a projection takes bf16 operands and returns fp32
  (``preferred_element_type=F32``): :func:`_proj` casts both operands to
  fp32 first, exact for bf16 inputs, with fp32 accumulation; the result
  is rounded to bf16 exactly where the JAX source calls
  ``.astype(x.dtype)``;
- softmax statistics are fp32.

Prefill attention has two paths that compute the same function up to
one rounding: ``blockwise_attention`` (the JAX package's model path,
which rounds p to v's dtype before p·V) and the flash-attention kernel
(``kernels.attention``, p·V in fp32), which ``self_attention``,
``mla_attention`` and the non-causal ``full_attention`` (an encoder's
self-attention, ``cross_attention``) run on a CUDA tensor.

The MoE's routing follows the JAX package's order exactly: top-K ties go
to the lowest expert (a stable descending sort, as ``lax.top_k``), a
token's place in its expert's buffer comes from a stable argsort, and a
token's K contributions are added onto zeros in k order (JAX's
scatter-add; ``index_add_`` would add them in a run-dependent order on a
card).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.params import ParamDef

F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, *ops):
    """``torch.einsum``; over DTensors (the sharded dry run and its
    test), ``distrib.sharding.local_einsum``, which runs it shard by
    shard."""
    if any(isinstance(o, DTensor) for o in ops):
        from repro_torch.distrib.sharding import local_einsum
        return local_einsum(eq, *ops)
    return torch.einsum(eq, *ops)


def reshape(x, shape):
    """``x.reshape(shape)``; a DTensor through ``distrib.sharding.reshape``,
    which keeps to layouts DTensor's rules accept."""
    if isinstance(x, DTensor):
        from repro_torch.distrib import sharding
        return sharding.reshape(x, shape)
    return x.reshape(shape)


def _proj(eq: str, x, w):
    """``einsum`` of bf16 operands with an fp32 result, as JAX's
    ``preferred_element_type=F32``: both operands are cast to fp32 (over
    DTensors after they are gathered, so the gathers move bf16)."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        from repro_torch.distrib.sharding import local_einsum
        return local_einsum(eq, x, w, dtype=F32)
    return torch.einsum(eq, x.to(F32), w.to(F32))


def spread(t) -> bool:
    """Whether ``t`` is a DTensor over more than one rank (on one rank
    the sharded path runs the single-device ops)."""
    return isinstance(t, DTensor) and t.device_mesh.size() > 1


def whole(t):
    """``t``; a DTensor with its pending partial sums (or maxima) reduced
    now, to a replicated layout: after a reduction over a sharded
    dimension, DTensor would otherwise reduce them into whatever layout
    the next op suggests (a reduce-scatter along the sequence, say), and
    the layouts around it would be gathered to meet it."""
    if isinstance(t, DTensor):
        from repro_torch.distrib.sharding import settle
        return settle(t)
    return t


def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.to(F32)
    var = whole(torch.mean(xf * xf, dim=-1, keepdim=True))
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.to(F32)
    mu = whole(torch.mean(xf, dim=-1, keepdim=True))
    var = whole(torch.var(xf, dim=-1, keepdim=True, unbiased=False))
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm_defs(cfg: ModelConfig, dim: int | None = None):
    d = dim or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"w": ParamDef((d,), (None,), init="ones"),
                "b": ParamDef((d,), (None,), init="zeros")}
    return {"w": ParamDef((d,), (None,), init="ones")}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ----------------------------------------------------------------- rope ----

def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2) in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                        device=positions.device)
                           / head_dim))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2). The
    split-half rotation (pairs i and i + hd/2), the JAX package's
    default; its ``REPRO_ROPE=interleaved`` switch is not carried, since
    the port reads no environment variable."""
    xf = x.to(F32)
    if cos.dim() == 2:  # (S, hd/2) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]   # (B, S, 1, hd/2)
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ----------------------------------------------- blockwise attention ------

def blockwise_attention(q, k, v, *, causal: bool, window: int | None = None,
                        q_positions=None, kv_positions=None,
                        block_kv: int = 512, scale: float | None = None):
    """Online-softmax attention over KV blocks; never materializes the
    (Sq, Skv) scores.

    q: (B, Sq, H, dk);  k: (B, Skv, KV, dk);  v: (B, Skv, KV, dv)
    GQA handled by grouping q heads over KV heads. Positions default to
    arange; pass explicit positions for offset decode/prefill windows.
    As in the JAX package, p is rounded to v's dtype before p·V.
    Returns (B, Sq, H, dv). Over DTensors it runs shard by shard
    (``distrib.sharding.local_region``), independent across batch and
    heads.
    """
    if isinstance(q, DTensor):
        from repro_torch.distrib.sharding import local_region
        out, = local_region(
            lambda q, k, v: (blockwise_attention(
                q, k, v, causal=causal, window=window,
                q_positions=q_positions, kv_positions=kv_positions,
                block_kv=block_kv, scale=scale),),
            ["bsHd", "btHd", "btHe"], ["bsHe"], q, k, v, parallel="bH")
        return out
    B, Sq, H, dk = q.shape
    _, Skv, KV, dv = v.shape
    assert H % KV == 0
    G = H // KV
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)

    # pad KV length to a block multiple
    nblk = (Skv + block_kv - 1) // block_kv
    pad = nblk * block_kv - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    # as in the JAX package, only a padded call masks negative positions
    valid = (kv_positions >= 0 if pad
             else torch.ones_like(kv_positions, dtype=torch.bool))

    qg = q.reshape(B, Sq, KV, G, dk).to(F32)
    neg = torch.full((), NEG_INF, dtype=F32, device=dev)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=F32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, dv), dtype=F32, device=dev)
    for j in range(nblk):
        sl = slice(j * block_kv, (j + 1) * block_kv)
        kj, vj, pj = k[:, sl], v[:, sl], kv_positions[sl]
        s = torch.einsum("bqkgd,bjkd->bqkgj", qg, kj.to(F32)) * scale
        mask = valid[sl][None, :].expand(Sq, -1)          # (Sq, bk)
        if causal:
            mask = mask & (pj[None, :] <= q_positions[:, None])
        if window is not None:
            mask = mask & (pj[None, :] > (q_positions[:, None] - window))
        s = torch.where(mask[None, :, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bqkgj,bjkd->bqkgd", p.to(vj.dtype).to(F32),
                          vj.to(F32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Sq, H, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, k_new, v_new, *, kv_len: int,
                     window: int | None = None, scale: float | None = None,
                     cache_positions=None):
    """Single-token attention against a cache.

    q: (B, 1, H, dk); caches: (B, S, KV, d*); k_new/v_new: (B, 1, KV, d*).
    The new token's KV is attended separately (the serving loop owns
    cache writes). ``cache_positions``: absolute token position of each
    cache slot (for rolled sliding-window caches); defaults to arange(S).
    """
    B, _, H, dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    dv = v_cache.shape[-1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = reshape(q, (B, KV, G, dk)).to(F32)

    s_c = einsum("bkgd,bskd->bkgs", qg, k_cache.to(F32)) * scale
    S = k_cache.shape[1]
    pos = (torch.arange(S, device=dev) if cache_positions is None
           else cache_positions)
    mask = (pos < kv_len) & (pos >= 0)
    if window is not None:
        mask = mask & (pos > kv_len - window)
    s_c = torch.where(mask[None, None, None, :], s_c,
                      torch.full((), NEG_INF, dtype=F32, device=dev))
    s_n = einsum("bkgd,bjkd->bkgj", qg, k_new.to(F32)) * scale

    m = torch.maximum(whole(s_c.amax(-1)), s_n[..., 0])
    p_c = torch.exp(s_c - m[..., None])
    p_n = torch.exp(s_n - m[..., None])
    l = whole(p_c.sum(-1)) + p_n[..., 0]
    ctx = einsum("bkgs,bskd->bkgd", p_c.to(v_cache.dtype).to(F32),
                 v_cache.to(F32))
    ctx = ctx + p_n * reshape(v_new, (B, KV, 1, dv)).to(F32)
    out = ctx / l[..., None]
    return reshape(out, (B, 1, H, dv)).to(q.dtype)


# --------------------------------------------------------- GQA attention ---

def attn_defs(cfg: ModelConfig):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("fsdp", "tp", "tp2"), init="scaled", fan_in=D),
        "wk": ParamDef((D, KV, hd), ("fsdp", "tp", "tp2"), init="scaled", fan_in=D),
        "wv": ParamDef((D, KV, hd), ("fsdp", "tp", "tp2"), init="scaled", fan_in=D),
        "wo": ParamDef((H, hd, D), ("tp", "tp2", "fsdp"), init="scaled", fan_in=H * hd),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((H, hd), ("tp", None), init="zeros")
        d["bk"] = ParamDef((KV, hd), ("tp", None), init="zeros")
        d["bv"] = ParamDef((KV, hd), ("tp", None), init="zeros")
    return d


def _qkv(cfg, p, x):
    q = _proj("bsd,dhk->bshk", x, p["wq"])
    k = _proj("bsd,dhk->bshk", x, p["wk"])
    v = _proj("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(F32)
        k = k + p["bk"].to(F32)
        v = v + p["bv"].to(F32)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def self_attention(cfg: ModelConfig, p, x, positions, *, window=None,
                   block_kv: int = 512, use_kernel: bool | None = None,
                   shardings=None):
    """Full-sequence causal self-attention (prefill). ``positions``: the
    tokens' positions, (S,). Returns (out, (k, v)) — caller decides
    whether to keep the cache.

    ``use_kernel=None`` runs the flash-attention kernel
    (``kernels.attention.ops.attention``) on a CUDA tensor and the plain
    ``blockwise_attention`` on the CPU; ``True`` runs the kernel's
    wrapper on either (its plain version on the CPU); ``False`` runs
    ``blockwise_attention`` on either, as the JAX package's model does.
    The kernel masks by sequence index; queries and keys share
    ``positions``, so that mask equals the positions' mask whenever they
    are consecutive (``forward_prefill`` passes 0..S-1; an offset start
    shifts queries and keys alike). Other positions raise on the kernel
    path rather than be masked wrongly.

    An "attn_qkv" spec in ``shardings`` (batch over every mesh axis)
    switches the region to pure data parallelism when the head count
    does not divide the tensor axis, as in the JAX package."""
    spec = shardings.get("attn_qkv") if shardings else None
    q, k, v = _qkv(cfg, p, x)
    if spec is not None:
        from repro_torch.distrib.sharding import constrain
        q, k, v = (constrain(t, spec) for t in (q, k, v))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        out = _kernel_attention("self_attention", q, k, v, positions,
                                window)
    else:
        out = blockwise_attention(q, k, v, causal=True, window=window,
                                  q_positions=positions,
                                  kv_positions=positions, block_kv=block_kv)
    out = _proj("bshk,hkd->bsd", out, p["wo"])
    return out.to(x.dtype), (k, v)


def _kernel_attention(who: str, q, k, v, positions, window=None):
    """Causal prefill attention on the kernel's call site
    (``ops.attention``, at the kernel's default scale 1/sqrt(d)). The
    kernel masks by sequence index: with consecutive positions that is
    the positions' mask; other positions raise."""
    consecutive = (positions.diff() == 1).all()
    out = attn_ops.attention(q, k, v, causal=True, window=window)
    # read after the launch: the host then waits while the kernel runs,
    # and the device does not idle for the check
    if not bool(consecutive):
        raise ValueError(f"{who}: the attention kernel masks by sequence "
                         f"index and needs consecutive positions; pass "
                         f"use_kernel=False for others")
    return out


def full_attention(q, k, v, *, block_kv: int = 512,
                   use_kernel: bool | None = None):
    """Non-causal attention of every query over every key: an encoder's
    self-attention and ``cross_attention``, where Sq may differ from Skv
    and no position is masked (the JAX package's
    ``blockwise_attention(q, k, v, causal=False)``). ``use_kernel`` as in
    ``self_attention``: on a card one flash-attention launch
    (``ops.attention(causal=False)``, which pads both sequence axes and
    masks the padded keys by ``kv_len``)."""
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    if use_kernel:
        # the kernel's default scale 1/sqrt(d) is blockwise_attention's
        # default 1/sqrt(dk)
        assert q.shape[-1] == k.shape[-1]
        return attn_ops.attention(q, k, v, causal=False)
    return blockwise_attention(q, k, v, causal=False, block_kv=block_kv)


def cross_attn_defs(cfg: ModelConfig):
    return attn_defs(cfg)


def cross_kv(cfg: ModelConfig, p, x_enc):
    """The K/V of encoder or image embeddings ``x_enc`` (B, Senc, D), each
    (B, Senc, KV, hd) in x_enc's dtype: what a cross layer attends to and
    its cache keeps."""
    k = _proj("bsd,dhk->bshk", x_enc, p["wk"])
    v = _proj("bsd,dhk->bshk", x_enc, p["wv"])
    return {"k": k.to(x_enc.dtype), "v": v.to(x_enc.dtype)}


def cross_attention(cfg: ModelConfig, p, x, kv_cache, *,
                    use_kernel: bool | None = None):
    """Cross-attention of x (B, S, D) to precomputed encoder or image K/V
    ``kv_cache`` {"k", "v"}, each (B, Senc, KV, hd): q has no rope, and
    nothing is masked (``full_attention``). Returns (B, S, D) in x's
    dtype."""
    q = _proj("bsd,dhk->bshk", x, p["wq"]).to(x.dtype)
    out = full_attention(q, kv_cache["k"], kv_cache["v"],
                         use_kernel=use_kernel)
    return _proj("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


def self_attention_decode(cfg: ModelConfig, p, x, pos: int, cache, *,
                          window=None):
    """x: (B, 1, D); pos: int (current position); cache: {'k','v'}.
    A windowed cache holds the last S tokens in time order (rolled), so its
    slot i corresponds to absolute position pos - S + i.
    Returns (out, (k_new, v_new)) — new KV for position ``pos``."""
    q, k_new, v_new = _qkv(cfg, p, x)
    posv = torch.tensor([pos], device=x.device)
    cos, sin = rope_cos_sin(posv, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    S = cache["k"].shape[1]
    cache_positions = None
    if window is not None and S <= window:
        cache_positions = pos - S + torch.arange(S, device=x.device)
    out = decode_attention(q, cache["k"], cache["v"], k_new, v_new,
                           kv_len=pos, window=window,
                           cache_positions=cache_positions)
    out = _proj("bshk,hkd->bsd", out, p["wo"])
    return out.to(x.dtype), (k_new, v_new)


# ------------------------------------------------------------------ MLA ----

def mla_defs(cfg: ModelConfig):
    D, H = cfg.d_model, cfg.num_heads
    nope, rope_d, dv, R = cfg.head_dim, cfg.rope_head_dim, cfg.v_hd, cfg.kv_lora_rank
    return {
        "wq": ParamDef((D, H, nope + rope_d), ("fsdp", "tp", None), init="scaled", fan_in=D),
        "w_dkv": ParamDef((D, R), ("fsdp", None), init="scaled", fan_in=D),
        "w_kr": ParamDef((D, rope_d), ("fsdp", None), init="scaled", fan_in=D),
        "w_uk": ParamDef((H, R, nope), ("tp", None, None), init="scaled", fan_in=R),
        "w_uv": ParamDef((H, R, dv), ("tp", None, None), init="scaled", fan_in=R),
        "wo": ParamDef((H, dv, D), ("tp", None, "fsdp"), init="scaled", fan_in=H * dv),
        "kv_norm": ParamDef((R,), (None,), init="ones"),
    }


def _mla_q(cfg, p, x, positions):
    """(q_nope, q_rope): the per-head query, its rope part roped."""
    nope, rope_d = cfg.head_dim, cfg.rope_head_dim
    q = _proj("bsd,dhk->bshk", x, p["wq"]).to(x.dtype)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_ckv(cfg, p, x, positions):
    """(ckv, kr): the normed kv latent (B, S, R) and the shared roped key
    (B, S, rope_d) — what the cache keeps."""
    ckv = rmsnorm(_proj("bsd,dr->bsr", x, p["w_dkv"]).to(x.dtype),
                  p["kv_norm"])
    kr = _proj("bsd,dk->bsk", x, p["w_kr"]).to(x.dtype)
    cos, sin = rope_cos_sin(positions, cfg.rope_head_dim, cfg.rope_theta)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, kr


def mla_qkv(cfg: ModelConfig, p, x, positions):
    """Prefill MLA's attention operands and cache: q and k ``nope +
    rope_d`` wide (the shared roped key broadcast over the heads), v
    ``v_hd`` wide, k_nope and v expanded from the latent and rounded to
    x's dtype. Returns (q, k, v, (ckv, kr))."""
    rope_d = cfg.rope_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, kr = _mla_ckv(cfg, p, x, positions)
    k_nope = _proj("bsr,hrk->bshk", ckv, p["w_uk"]).to(x.dtype)
    v = _proj("bsr,hrk->bshk", ckv, p["w_uv"]).to(x.dtype)
    B, S, H = x.shape[0], x.shape[1], cfg.num_heads
    k_rope_b = kr[:, :, None, :].expand(B, S, H, rope_d)
    qc = torch.cat([q_nope, q_rope], -1)
    kc = torch.cat([k_nope, k_rope_b], -1)
    return qc, kc, v, (ckv, kr)


def mla_attention(cfg: ModelConfig, p, x, positions, *, block_kv: int = 512,
                  use_kernel: bool | None = None):
    """Prefill MLA: per-head K/V expanded from the latent, q and k
    ``nope + rope_d`` wide (DeepSeek-V2-Lite: 192), v ``v_hd`` wide (128).
    Returns (out, (ckv, kr)), the cache. ``use_kernel`` as in
    ``self_attention``: on a card one flash-attention launch, whose
    default scale 1/sqrt(d) is MLA's 1/sqrt(nope + rope_d)."""
    nope, rope_d = cfg.head_dim, cfg.rope_head_dim
    qc, kc, v, (ckv, kr) = mla_qkv(cfg, p, x, positions)
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        assert qc.shape[-1] == nope + rope_d   # the kernel's default scale
        out = _kernel_attention("mla_attention", qc, kc, v, positions)
    else:
        out = blockwise_attention(qc, kc, v, causal=True,
                                  q_positions=positions,
                                  kv_positions=positions, block_kv=block_kv,
                                  scale=1.0 / math.sqrt(nope + rope_d))
    out = _proj("bshk,hkd->bsd", out, p["wo"])
    return out.to(x.dtype), (ckv, kr)


def mla_attention_decode(cfg: ModelConfig, p, x, pos: int, cache):
    """Absorbed-form MLA decode, in fp32 as the JAX package computes it:
    scores and values in the latent space, W_uk folded into q and W_uv
    applied after. cache: {'ckv': (B, S, R), 'kr': (B, S, rope_d)}, slots
    ``< pos`` valid; the new token is attended separately. Returns (out,
    (ckv_new, kr_new))."""
    nope, rope_d = cfg.head_dim, cfg.rope_head_dim
    dev = x.device
    posv = torch.arange(pos, pos + 1, device=dev)   # no host-to-device copy
    q_nope, q_rope = _mla_q(cfg, p, x, posv)
    ckv_new, kr_new = _mla_ckv(cfg, p, x, posv)
    q_lat = _proj("bshk,hrk->bhr", q_nope, p["w_uk"])
    qr = q_rope.to(F32)
    scale = 1.0 / math.sqrt(nope + rope_d)
    ckv_c = cache["ckv"].to(F32)
    s_c = (einsum("bhr,bsr->bhs", q_lat, ckv_c)
           + einsum("bshk,btk->bht", qr, cache["kr"].to(F32))) * scale
    S = ckv_c.shape[1]
    mask = torch.arange(S, device=dev) < pos
    s_c = torch.where(mask[None, None, :], s_c,
                      torch.full((), NEG_INF, dtype=F32, device=dev))
    s_n = (einsum("bhr,bsr->bh", q_lat, ckv_new.to(F32))
           + einsum("bshk,bsk->bh", qr, kr_new.to(F32))) * scale
    m = torch.maximum(whole(s_c.amax(-1)), s_n)
    p_c = torch.exp(s_c - m[..., None])
    p_n = torch.exp(s_n - m)
    l = whole(p_c.sum(-1)) + p_n
    ctx = einsum("bhs,bsr->bhr", p_c, ckv_c)
    ctx = (ctx + p_n[..., None] * ckv_new[:, 0, None, :].to(F32)) \
        / l[..., None]
    v = einsum("bhr,hrk->bhk", ctx, p["w_uv"].to(F32))
    out = einsum("bhk,hkd->bd", v, p["wo"].to(F32))
    return out[:, None, :].to(x.dtype), (ckv_new, kr_new)


# ------------------------------------------------------------------ MLP ----

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None):
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wg": ParamDef((D, F_), ("fsdp", "tp"), init="scaled", fan_in=D),
                "wu": ParamDef((D, F_), ("fsdp", "tp"), init="scaled", fan_in=D),
                "wd": ParamDef((F_, D), ("tp", "fsdp"), init="scaled", fan_in=F_)}
    return {"w1": ParamDef((D, F_), ("fsdp", "tp"), init="scaled", fan_in=D),
            "b1": ParamDef((F_,), ("tp",), init="zeros"),
            "w2": ParamDef((F_, D), ("tp", "fsdp"), init="scaled", fan_in=F_),
            "b2": ParamDef((D,), (None,), init="zeros")}


def mlp(cfg: ModelConfig, p, x):
    if cfg.act == "swiglu":
        g = _proj("bsd,df->bsf", x, p["wg"])
        u = _proj("bsd,df->bsf", x, p["wu"])
        h = (F.silu(g) * u).to(x.dtype)
        return _proj("bsf,fd->bsd", h, p["wd"]).to(x.dtype)
    h = _proj("bsd,df->bsf", x, p["w1"]) + p["b1"].to(F32)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h, approximate="tanh").to(x.dtype)
    return (_proj("bsf,fd->bsd", h, p["w2"])
            + p["b2"].to(F32)).to(x.dtype)


# ------------------------------------------------------------------ MoE ----

def moe_defs(cfg: ModelConfig):
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    d = {
        "router": ParamDef((D, E), (None, None), init="scaled", fan_in=D,
                           dtype=torch.float32),
        "wg": ParamDef((E, D, F_), ("ep", "fsdp", "tp"), init="scaled", fan_in=D),
        "wu": ParamDef((E, D, F_), ("ep", "fsdp", "tp"), init="scaled", fan_in=D),
        "wd": ParamDef((E, F_, D), ("ep", "tp", "fsdp"), init="scaled", fan_in=F_),
    }
    if cfg.num_shared_experts:
        d["shared"] = mlp_defs(cfg, d_ff=F_ * cfg.num_shared_experts)
    return d


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens, with the JAX package's Python
    float arithmetic."""
    E, K = cfg.num_experts, cfg.experts_per_token
    return max(int(math.ceil(T * K * cfg.capacity_factor / E)), 1)


def _expert_counts(flat_e, E: int):
    """``bincount(flat_e, length=E)`` by a scatter-add: torch's CUDA
    bincount reads the input's maximum back to the host, a sync in every
    MoE layer."""
    return torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))


def moe_route(cfg: ModelConfig, router, xt):
    """Routing of T tokens ``xt`` (T, D): returns a dict of the router's
    ``probs`` (T, E) fp32, the normalised top-K weights ``w`` (T, K) and
    experts ``idx`` (T, K) — descending, ties to the lowest expert, as
    ``lax.top_k`` — and, per (token, k) entry in that order, ``keep``
    (it has a place within capacity C) and ``slot`` (its row of the
    (E * C + 1, D) dispatch buffer: ``idx * C + place``, or the spare row
    E * C when dropped), with ``C``, ``flat_e`` and each expert's entry
    ``counts`` (E,)."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = xt.to(F32) @ router.to(F32)                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :K], order[:, :K]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    C = moe_capacity(cfg, T)
    flat_e = idx.reshape(-1)                                  # (T*K,)
    # each entry's place within its expert, by stable sort
    srt = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(srt)
    ranks[srt] = torch.arange(T * K, device=xt.device)
    counts = _expert_counts(flat_e, E)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = ranks - offsets[flat_e]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full((), E * C, dtype=flat_e.dtype,
                                  device=xt.device))
    return dict(probs=probs, w=w, idx=idx, flat_e=flat_e, keep=keep,
                slot=slot, C=C, counts=counts)


def moe_combine(contrib, K: int):
    """Sum each token's K fp32 contributions (rows t K .. t K + K - 1 of
    ``contrib``, (T K, D)) onto zeros in k order: JAX's
    ``zeros.at[repeat(arange(T), K)].add(contrib)``, whose adds run in
    that order, bit for bit. Returns (T, D)."""
    T = contrib.shape[0] // K
    c = contrib.reshape(T, K, -1)
    out = torch.zeros_like(c[:, 0])
    for k in range(K):
        out = out + c[:, k]
    return out


def _replicated(fn, *args, outputs: int = 1):
    """``fn(*args)``; over DTensors, on whole replicas
    (``distrib.sharding.replicated``): the MoE's routing sorts and
    scatters over every token, which DTensor has no rule for."""
    if any(isinstance(a, DTensor) for a in args):
        from repro_torch.distrib.sharding import replicated
        return replicated(fn, *args, outputs=outputs)
    return fn(*args)


def _moe_route(cfg: ModelConfig, router, x):
    """Routing of the B * S tokens of ``x`` (B, S, D) (``moe_route``):
    (w, keep, slot, aux), aux the Switch-style load-balancing loss
    ``E * sum(mean probs * load)``."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    r = moe_route(cfg, router, x.reshape(T, D))
    load = r["counts"].to(F32) / (T * K)
    aux = E * torch.sum(r["probs"].mean(0) * load)
    return r["w"], r["keep"], r["slot"], aux


def _moe_dispatch(E: int, C: int, x, slot):
    """The (E, C, D) buffer of the tokens of ``x`` (B, S, D) packed by
    expert: entry j (token j // K) at row ``slot[j]``."""
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    K = slot.shape[0] // T
    tok_ids = torch.arange(T, device=x.device)[:, None].expand(T, K) \
        .reshape(-1)
    # dropped entries all land on the spare row E * C, which is cut off
    # (the drop-scatter convention of core/scatter.py)
    buf = x.new_zeros((E * C + 1, D)).index_put((slot,), xt[tok_ids])
    return buf[:E * C].reshape(E, C, D)


def _moe_gather(K: int, shape, ye, w, keep, slot):
    """Each token's K expert outputs from ``ye`` (E, C, D) fp32, weighted
    and summed in k order (0 for a dropped entry), as an fp32 tensor of
    the tokens' ``shape`` (B, S, D)."""
    E, C, D = ye.shape
    flat_y = ye.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           flat_y[torch.clamp_max(slot, E * C - 1)], 0.0)
    return moe_combine(gathered * w.reshape(-1)[:, None], K).reshape(shape)


def moe(cfg: ModelConfig, p, x, *, dispatch_spec=None):
    """Top-K MoE with sort-based capacity dispatch (drop on overflow), the
    JAX package's ``moe``. x: (B, S, D). Tokens are routed
    (``moe_route``), packed by expert into an (E, C, D) buffer, run
    through the experts as batched products, and combined with their
    router weights; an entry past its expert's capacity contributes 0.
    Returns out (B, S, D) in x's dtype and the Switch-style
    load-balancing loss ``E * sum(mean probs * load)`` (the JAX package's
    ``return_aux=True``). ``dispatch_spec`` pins the (E, C, D) buffer and
    the experts' outputs to the expert-parallel layout, as JAX's; over
    DTensors each rank then builds and reads only its block of it
    (``distrib.sharding.expert_dispatch``/``expert_combine``)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, B * S)
    xr = x
    if isinstance(x, DTensor):
        # the routing ranks every token: gather them once, for it and
        # for the dispatch
        xr = x.redistribute(x.device_mesh, x.device_mesh.ndim
                            * [torch.distributed.tensor.Replicate()])
    w, keep, slot, aux = _replicated(
        functools.partial(_moe_route, cfg), p["router"], xr, outputs=4)
    sharded = spread(x) and dispatch_spec is not None
    if sharded:
        from repro_torch.distrib import sharding as SH
        xe = SH.expert_dispatch(xr, slot, E, C, dispatch_spec)
    else:
        xe = _replicated(functools.partial(_moe_dispatch, E, C), xr, slot)
    g = _proj("ecd,edf->ecf", xe, p["wg"])
    u = _proj("ecd,edf->ecf", xe, p["wu"])
    h = (F.silu(g) * u).to(x.dtype)
    ye = _proj("ecf,efd->ecd", h, p["wd"])                   # (E, C, D) f32
    if sharded:
        out = SH.expert_combine(SH.constrain(ye, dispatch_spec), w, slot, x)
    else:
        out = _replicated(functools.partial(_moe_gather, K, x.shape), ye, w,
                          keep, slot)
    if cfg.num_shared_experts:
        out = out + mlp(cfg, p["shared"], x).to(F32)
    return out.to(x.dtype), aux
