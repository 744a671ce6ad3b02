"""Plain PyTorch version of the flash-attention kernel: naive attention
in fp32, the same function as the JAX package's
``kernels/attention/ref.py:attention_ref``."""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, kv_len: int | None = None):
    """Naive attention. q: (B,Sq,H,d); k/v: (B,Skv,KV,d|dv); GQA maps
    query head h to kv head h // (H // KV). All math in fp32; masked
    scores are the finite NEG_INF, so a row with no valid key averages v
    over every key. float64 inputs are computed in float64 (an oracle
    for the fp32 paths). Returns (B,Sq,H,dv) in q's dtype."""
    B, Sq, H, d = q.shape
    _, Skv, KV, dv = v.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = Skv if kv_len is None else kv_len

    acc = torch.float64 if q.dtype == torch.float64 else F32
    qf = q.to(acc).reshape(B, Sq, KV, G, d)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bqkgd,bjkd->bqkgj", qf, kf) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.full((), NEG_INF, dtype=acc, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqkgj,bjkd->bqkgd", p, vf)
    return o.reshape(B, Sq, H, dv).to(q.dtype)
