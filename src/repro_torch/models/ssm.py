"""Mamba2 (SSD — state-space duality) block, the port of the JAX
package's ``models/ssm.py``.

The chunked dual form: within a chunk the recurrence is evaluated as a
masked quadratic (attention-like) product; across chunks a small
per-head state (P x N) is carried. ``ssd_chunked`` is the plain PyTorch
form of it (the JAX package's XLA path); the hand-written CUDA kernel in
``repro_torch.kernels.ssd`` computes the same function and is what
``mamba_block`` runs on a CUDA tensor.

Casts follow the JAX package op for op: projections take bf16 weights
and activations and return fp32 (``preferred_element_type=F32``), so the
port casts both operands to fp32 before the product — exact for bf16
inputs, with fp32 accumulation. fp32 products on the card run in full
fp32: the port leaves ``torch.backends.cuda.matmul.allow_tf32`` at its
default, False (TF32 would move the logits beyond the stated
tolerances).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import _proj, einsum, reshape, rmsnorm
from repro_torch.models.params import ParamDef

F32 = torch.float32


def ssm_defs(cfg: ModelConfig):
    D, din = cfg.d_model, cfg.d_inner
    H, P, N, W = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_conv_width)
    return {
        "w_z": ParamDef((D, H, P), ("fsdp", "tp", "tp2"), init="scaled", fan_in=D),
        "w_x": ParamDef((D, H, P), ("fsdp", "tp", "tp2"), init="scaled", fan_in=D),
        "w_B": ParamDef((D, N), ("fsdp", None), init="scaled", fan_in=D),
        "w_C": ParamDef((D, N), ("fsdp", None), init="scaled", fan_in=D),
        "w_dt": ParamDef((D, H), ("fsdp", "tp"), init="scaled", fan_in=D),
        "dt_bias": ParamDef((H,), ("tp",), init="zeros"),
        "A_log": ParamDef((H,), ("tp",), init="zeros"),       # A = -exp(A_log)
        "D_skip": ParamDef((H,), ("tp",), init="ones"),
        "conv_x": ParamDef((W, H, P), (None, "tp", "tp2"), init="scaled", fan_in=W),
        "conv_B": ParamDef((W, N), (None, None), init="scaled", fan_in=W),
        "conv_C": ParamDef((W, N), (None, None), init="scaled", fan_in=W),
        "norm": ParamDef((H, P), ("tp", "tp2"), init="ones"),
        "w_out": ParamDef((H, P, D), ("tp", "tp2", "fsdp"), init="scaled", fan_in=din),
    }


def _causal_conv(x, kernel):
    """Depthwise causal conv. x: (B, S, C...), kernel: (W, C...). Over
    DTensors it runs shard by shard (``distrib.sharding.local_region``),
    independent across batch and channels."""
    if isinstance(x, DTensor):
        from repro_torch.distrib.sharding import local_region
        ch = "cdef"[:x.dim() - 2]
        y, = local_region(lambda x, k: (_causal_conv(x, k),),
                          ["bs" + ch, "w" + ch], ["bs" + ch], x, kernel,
                          parallel="b" + ch)
        return y
    W, S = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0) * (x.dim() - 2) + (W - 1, 0))
    return sum(xp[:, i:i + S] * kernel[i] for i in range(W))


def segsum_decay(dA):
    """dA: (..., L) -> decay matrix exp(cumsum_i - cumsum_j), lower
    triangular, (..., L, L) in f32, zero above the diagonal. The exponent
    is taken only where i >= j (above it, -inf gives 0)."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward. x: (b,s,h,p) dt: (b,s,h) A: (h,) B,C: (b,s,n).
    Returns y: (b,s,h,p) f32 and final state (b,h,p,n). Over DTensors it
    runs shard by shard (``distrib.sharding.local_region``), independent
    across batch, heads and head dims."""
    if isinstance(x, DTensor):
        from repro_torch.distrib.sharding import local_region
        return local_region(
            lambda *ts: ssd_chunked(*ts, chunk),
            ["bshp", "bsh", "h", "bsn", "bsn"], ["bshp", "bhpn"],
            x, dt, A, B, C, parallel="bhp")
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    S = s + pad
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(b, nc, chunk, h).to(F32)
    Bc = B.reshape(b, nc, chunk, n).to(F32)
    Cc = C.reshape(b, nc, chunk, n).to(F32)

    dA = dtc * A.to(F32)                                      # (b,nc,l,h)
    dA_h = dA.permute(0, 1, 3, 2)                             # (b,nc,h,l)
    cums = torch.cumsum(dA_h, dim=-1)                         # (b,nc,h,l)

    # ---- intra-chunk (quadratic) term
    Lmat = segsum_decay(dA_h)                                 # (b,nc,h,l,l)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # (b,nc,l,l)
    att = cb[:, :, None] * Lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att, xc)

    # ---- per-chunk input -> state
    decay_to_end = torch.exp(cums[..., -1:] - cums)           # (b,nc,h,l)
    sx = xc * (dtc * decay_to_end.permute(0, 1, 3, 2))[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, sx)        # (b,nc,h,p,n)

    # ---- inter-chunk recurrence (emit the state *before* each chunk)
    chunk_decay = torch.exp(cums[..., -1])                    # (b,nc,h)
    st = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    before = []
    for c in range(nc):
        before.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    st_before = torch.stack(before, 1)                        # (b,nc,h,p,n)

    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, st_before,
                           torch.exp(cums).permute(0, 1, 3, 2))
    y = (y_intra + y_inter).reshape(b, S, h, p)[:, :s]
    return y, st


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token SSD update. state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    B,C: (b,n). Returns (y (b,h,p), new_state)."""
    dA = torch.exp(dt.to(F32) * A.to(F32))                    # (b,h)
    dBx = einsum("bn,bhp->bhpn", B.to(F32),
                 x.to(F32) * dt.to(F32)[..., None])
    new_state = state * dA[..., None, None] + dBx
    y = einsum("bhpn,bn->bhp", new_state, C.to(F32))
    return y, new_state


def ssd_inputs(cfg: ModelConfig, p, x):
    """The mixer's projections up to the SSD: ``(z, xin, dt, A, Bv, Cv,
    conv_tail)`` for x (B, S, D), where ``xin``/``Bv``/``Cv`` are the
    SSD's bf16 operands after the causal conv and SiLU, ``dt`` and ``A``
    fp32, and ``conv_tail`` the last W-1 pre-conv features (for decode
    continuation)."""
    Bsz, S, D = x.shape
    H, P, N, W = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_conv_width)
    z = _proj("bsd,dhp->bshp", x, p["w_z"])
    xin = _proj("bsd,dhp->bshp", x, p["w_x"]).to(x.dtype)
    Bv = _proj("bsd,dn->bsn", x, p["w_B"]).to(x.dtype)
    Cv = _proj("bsd,dn->bsn", x, p["w_C"]).to(x.dtype)
    dt = _proj("bsd,dh->bsh", x, p["w_dt"])
    # torch's softplus returns x itself above threshold=20, where JAX's
    # log(1 + exp(x)) differs from x by less than fp32 resolves
    dt = F.softplus(dt + p["dt_bias"].to(F32))

    # the last W-1 rows (all of them when S < W-1, padded in front)
    tail = torch.cat([reshape(xin[:, -(W - 1):], (Bsz, -1, H * P)),
                      Bv[:, -(W - 1):], Cv[:, -(W - 1):]], -1)
    conv_tail = tail if S >= W - 1 else F.pad(tail, (0, 0, W - 1 - S, 0))

    xin = F.silu(_causal_conv(xin, p["conv_x"]).to(F32)).to(x.dtype)
    Bv = F.silu(_causal_conv(Bv, p["conv_B"]).to(F32)).to(x.dtype)
    Cv = F.silu(_causal_conv(Cv, p["conv_C"]).to(F32)).to(x.dtype)
    A = -torch.exp(p["A_log"].to(F32))
    return z, xin, dt, A, Bv, Cv, conv_tail


def mamba_block(cfg: ModelConfig, p, x, *, use_kernel: bool | None = None):
    """Full-sequence Mamba2 mixer. x: (B, S, D) ->
    (out, (final_state, conv_tail)) where conv_tail holds the last W-1
    pre-conv features (for decode continuation).

    ``use_kernel=None`` runs the SSD kernel (``kernels.ssd.ops.ssd``) on
    a CUDA tensor and the plain ``ssd_chunked`` on the CPU; ``True`` runs
    the kernel's wrapper on either (its plain version on the CPU);
    ``False`` runs ``ssd_chunked`` on either, as the JAX package does by
    default."""
    z, xin, dt, A, Bv, Cv, conv_tail = ssd_inputs(cfg, p, x)
    if use_kernel is None:
        use_kernel = x.device.type == "cuda"
    if use_kernel:
        y, final = ssd_ops.ssd(xin, dt, A, Bv, Cv, chunk=cfg.ssm_chunk)
    else:
        y, final = ssd_chunked(xin, dt, A, Bv, Cv, cfg.ssm_chunk)
    y = y + p["D_skip"].to(F32)[None, None, :, None] * xin.to(F32)
    y = y * F.silu(z)
    y = rmsnorm(y.to(x.dtype), p["norm"])
    out = _proj("bshp,hpd->bsd", y, p["w_out"])
    return out.to(x.dtype), (final, conv_tail)


def mamba_block_decode(cfg: ModelConfig, p, x, cache):
    """One-token Mamba2 step. x: (B, 1, D);
    cache: {'state': (B,H,P,N), 'conv': (B, W-1, H*P + 2N)}."""
    Bsz, _, D = x.shape
    H, P, N, W = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_conv_width)
    xt = x[:, 0]
    z = _proj("bd,dhp->bhp", xt, p["w_z"])
    xin = _proj("bd,dhp->bhp", xt, p["w_x"])
    Bv = _proj("bd,dn->bn", xt, p["w_B"])
    Cv = _proj("bd,dn->bn", xt, p["w_C"])
    dt = _proj("bd,dh->bh", xt, p["w_dt"])
    dt = F.softplus(dt + p["dt_bias"].to(F32))

    # conv ring: cache['conv'] holds the last W-1 pre-conv features
    feat = torch.cat([reshape(xin, (Bsz, H * P)), Bv, Cv], -1)    # (B, HP+2N)
    hist = torch.cat([cache["conv"].to(F32), feat[:, None, :]], 1)  # (B, W, .)
    kx = reshape(p["conv_x"], (W, H * P)).to(F32)
    kB = p["conv_B"].to(F32)
    kC = p["conv_C"].to(F32)
    xc = einsum("bwc,wc->bc", hist[..., :H * P], kx)
    Bc = einsum("bwc,wc->bc", hist[..., H * P:H * P + N], kB)
    Cc = einsum("bwc,wc->bc", hist[..., H * P + N:], kC)
    xc = reshape(F.silu(xc), (Bsz, H, P))
    Bc, Cc = F.silu(Bc), F.silu(Cc)

    A = -torch.exp(p["A_log"].to(F32))
    y, new_state = ssd_decode_step(cache["state"].to(F32), xc, dt, A, Bc, Cc)
    y = y + p["D_skip"].to(F32)[None, :, None] * xc
    y = y * F.silu(z)
    y = rmsnorm(y.to(x.dtype), p["norm"])
    out = _proj("bhp,hpd->bd", y, p["w_out"])
    new_cache = {"state": new_state.to(cache["state"].dtype),
                 "conv": hist[:, 1:].to(cache["conv"].dtype)}
    return out[:, None, :].to(x.dtype), new_cache


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    H, P, N, W = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_conv_width)
    return {"state": (batch, H, P, N), "conv": (batch, W - 1, H * P + 2 * N)}
