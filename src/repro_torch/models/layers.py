"""The JAX package's ``models/layers.py`` for dense models: norms, rope,
GQA self-attention (prefill and decode) and the MLP. MLA, cross-attention
and MoE are not ported yet (ROADMAP A11).

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
(``kernels.attention``, p·V in fp32), which ``self_attention`` runs on a
CUDA tensor.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.params import ParamDef

F32 = torch.float32
NEG_INF = -1e30


def _proj(eq: str, x, w):
    """``einsum`` of bf16 operands with an fp32 result, as JAX's
    ``preferred_element_type=F32``: both operands are cast to fp32."""
    return torch.einsum(eq, x.to(F32), w.to(F32))


def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
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
    Returns (B, Sq, H, dv).
    """
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
    qg = q.reshape(B, KV, G, dk).to(F32)

    s_c = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(F32)) * scale
    S = k_cache.shape[1]
    pos = (torch.arange(S, device=dev) if cache_positions is None
           else cache_positions)
    mask = (pos < kv_len) & (pos >= 0)
    if window is not None:
        mask = mask & (pos > kv_len - window)
    s_c = torch.where(mask[None, None, None, :], s_c,
                      torch.full((), NEG_INF, dtype=F32, device=dev))
    s_n = torch.einsum("bkgd,bjkd->bkgj", qg, k_new.to(F32)) * scale

    m = torch.maximum(s_c.amax(-1), s_n[..., 0])
    p_c = torch.exp(s_c - m[..., None])
    p_n = torch.exp(s_n - m[..., None])
    l = p_c.sum(-1) + p_n[..., 0]
    ctx = torch.einsum("bkgs,bskd->bkgd", p_c.to(v_cache.dtype).to(F32),
                       v_cache.to(F32))
    ctx = ctx + p_n * v_new.reshape(B, KV, 1, dv).to(F32)
    out = ctx / l[..., None]
    return out.reshape(B, 1, H, dv).to(q.dtype)


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
                   block_kv: int = 512, use_kernel: bool | None = None):
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
    path rather than be masked wrongly."""
    q, k, v = _qkv(cfg, p, x)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        consecutive = (positions.diff() == 1).all()
        out = attn_ops.attention(q, k, v, causal=True, window=window)
        # read after the launch: the host then waits while the kernel
        # runs, and the device does not idle for the check
        if not bool(consecutive):
            raise ValueError("self_attention: the attention kernel masks by "
                             "sequence index and needs consecutive "
                             "positions; pass use_kernel=False for others")
    else:
        out = blockwise_attention(q, k, v, causal=True, window=window,
                                  q_positions=positions,
                                  kv_positions=positions, block_kv=block_kv)
    out = _proj("bshk,hkd->bsd", out, p["wo"])
    return out.to(x.dtype), (k, v)


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
