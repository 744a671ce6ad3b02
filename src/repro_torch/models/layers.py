"""Norms of the JAX package's ``models/layers.py`` (the part an ``ssm``
model uses). Attention, MLP, MoE and rope wait for an attention model
(ROADMAP A11/B5).

The casts follow the JAX package: the normalization runs in fp32, is
rounded to the input's dtype, and only then multiplied by the weight, so
for bf16 activations the product with ``w`` is taken (and rounded) in
bf16.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

F32 = torch.float32


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
