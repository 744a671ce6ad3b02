"""AdamW (from scratch) with global-norm clipping and a cosine schedule:
the JAX package's ``training/optimizer.py`` on tensor trees.

Every scalar is a 0-d fp32 tensor on the parameters' device, because
JAX computes them in fp32: its Python floats are weakly typed, so
``lr``, ``b1 ** step``, ``b2 ** step`` and the clip scale are fp32
arithmetic there. The same values in Python double would move ``lr``
and the bias corrections by an ulp, and flip bf16 parameters. A Python
float that meets an fp32 tensor is rounded to fp32 first, as JAX rounds
a weak float; divisions take two tensors (``Tensor.__rtruediv__`` would
multiply by a reciprocal instead). Nothing here reads a value back to
the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import flatten, paths, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Any = torch.float32   # set bfloat16 to halve optimizer memory


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to fp32, as a 0-d tensor on ``like``'s device."""
    return torch.full((), v, dtype=F32, device=like.device)


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac * lr``; ``step``
    an integer 0-d tensor, the result a 0-d fp32 tensor."""
    step = step.to(F32)
    warm = torch.clamp_max(step / _f32(max(oc.warmup_steps, 1), step), 1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / _f32(max(oc.total_steps - oc.warmup_steps, 1), step),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * cos
    return oc.lr * warm * frac


def init_opt_state(params, oc: OptConfig) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=oc.state_dtype,
                                  device=p.device)
    first = flatten(params)[0]
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _decay_mask(path: tuple) -> bool:
    """Apply weight decay only to matrices (skip norms/biases/scalars)."""
    return str(path[-1]) not in ("w", "b", "bq", "bk", "bv", "b1", "b2",
                                 "dt_bias", "A_log", "D_skip", "norm",
                                 "kv_norm")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in flatten order, of each leaf's fp32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(x.to(F32) ** 2) for x in flatten(tree)))


def adamw_update(params, grads, opt_state, oc: OptConfig):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    lr = schedule(oc, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        _f32(oc.clip_norm, gnorm) / torch.clamp_min(gnorm, 1e-9), 1.0)

    b1, b2 = oc.beta1, oc.beta2
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(b2, stepf), stepf)

    new_p, new_m, new_v = [], [], []
    for path, p, g, m, v in zip(paths(params), flatten(params),
                                flatten(grads), flatten(opt_state["m"]),
                                flatten(opt_state["v"])):
        g = g.to(F32) * scale
        m2 = b1 * m.to(F32) + (1 - b1) * g
        v2 = b2 * v.to(F32) + (1 - b2) * g * g
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + oc.eps)
        if oc.weight_decay and _decay_mask(path):
            upd = upd + oc.weight_decay * p.to(F32)
        new_p.append((p.to(F32) - lr * upd).to(p.dtype))
        new_m.append(m2.to(oc.state_dtype))
        new_v.append(v2.to(oc.state_dtype))

    new_state = {"m": unflatten(params, new_m),
                 "v": unflatten(params, new_v),
                 "step": step}
    return unflatten(params, new_p), new_state, {"grad_norm": gnorm,
                                                 "lr": lr}
