"""Model assembly for ``ssm`` architectures, the part of the JAX
package's ``models/model.py`` an attention-free model runs.

Entrypoints
-----------
- ``model_defs(cfg)``        -> ParamDef tree (single source of truth)
- ``forward_prefill(...)``   -> (last-token logits, caches)
- ``forward_decode(...)``    -> (logits, new caches) for one token
- ``cache_shapes(cfg, ...)`` -> tree of cache shapes for decode
- ``count_model_params(cfg)``

Parameters and caches keep the JAX package's stacked layout: every leaf
under ``blocks`` carries a leading block axis ``nb`` (``blocks/s0/...``).
Where JAX runs ``lax.scan`` over that axis, the port loops over the
blocks in Python, so a tree carried across from JAX
(:func:`repro_torch.convert.params_from_jax`) is used as it is. Layers of
other kinds (attention, cross-attention, MLP/MoE, encoder) raise
``NotImplementedError`` naming ROADMAP A11/B5.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamDef, count_params, stack_defs

F32 = torch.float32


def _unported(what: str):
    return NotImplementedError(
        f"{what}: the port runs ssm layers only; attention, cross-attention, "
        f"MLP/MoE and encoder layers are ROADMAP A11/B5")


# ------------------------------------------------------------- defs tree ---

def layer_defs(cfg: ModelConfig, l: int):
    kind = cfg.layer_kind(l)
    if kind != "ssm":
        raise _unported(f"layer {l} of {cfg.name} is {kind!r}")
    if cfg.is_encoder_decoder:
        raise _unported(f"{cfg.name} is an encoder-decoder")
    if cfg.d_ff > 0 or cfg.is_moe_layer(l):
        raise _unported(f"layer {l} of {cfg.name} has a feed-forward block")
    return {"norm1": L.norm_defs(cfg), "mixer": S.ssm_defs(cfg)}


def model_defs(cfg: ModelConfig):
    Vp, D = cfg.padded_vocab(), cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((Vp, D), ("tp", "fsdp"), init="normal"),
        "final_norm": L.norm_defs(cfg),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((D, Vp), ("fsdp", "tp"),
                                   init="scaled", fan_in=D)
    npfx = cfg.first_dense_layers
    if npfx:
        defs["prefix"] = {f"p{i}": layer_defs(cfg, i) for i in range(npfx)}
    nscan = cfg.num_layers - npfx
    assert nscan % cfg.block_period == 0
    nb = nscan // cfg.block_period
    block = {f"s{i}": layer_defs(cfg, npfx + i)
             for i in range(cfg.block_period)}
    defs["blocks"] = stack_defs(block, nb)
    return defs


def n_scan_blocks(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_dense_layers) // cfg.block_period


def _index(tree, i: int):
    """Block ``i`` of a stacked tree (every leaf's leading axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    """Stack per-block trees along a new leading axis (``lax.scan``'s
    stacked outputs)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# --------------------------------------------------------- layer forward ---

def layer_forward(cfg: ModelConfig, lp, x, l: int, *,
                  use_kernel: bool | None = None):
    """One layer, full sequence (prefill). Returns (x, new_cache).
    ``use_kernel`` is passed to ``mamba_block``."""
    kind = cfg.layer_kind(l)
    if kind != "ssm":
        raise _unported(f"layer {l} of {cfg.name} is {kind!r}")
    h = L.apply_norm(cfg, lp["norm1"], x)
    y, (final_state, conv_tail) = S.mamba_block(cfg, lp["mixer"], h,
                                                use_kernel=use_kernel)
    return x + y, {"state": final_state.to(x.dtype),
                   "conv": conv_tail.to(x.dtype)}


def layer_decode(cfg: ModelConfig, lp, x, l: int, *, pos, cache):
    """One layer, one token. Returns (x, cache_delta)."""
    kind = cfg.layer_kind(l)
    if kind != "ssm":
        raise _unported(f"layer {l} of {cfg.name} is {kind!r}")
    h = L.apply_norm(cfg, lp["norm1"], x)
    y, delta = S.mamba_block_decode(cfg, lp["mixer"], h, cache)
    return x + y, delta


# ----------------------------------------------------------- full stacks ---

def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _logits(cfg, params, x):
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x.to(F32), w.to(F32))
    # mask padded vocab entries
    Vp = cfg.padded_vocab()
    if Vp != cfg.vocab_size:
        mask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full((), -1e9, dtype=F32,
                                                      device=logits.device))
    return logits


def forward_prefill(cfg: ModelConfig, params, tokens, *,
                    use_kernel: bool | None = None):
    """tokens: (B, S) -> (logits for last position (B, Vp), caches tree).

    Cache leaves are stacked over blocks: (nb, B, ...). ``use_kernel``
    goes to every layer's ``mamba_block`` (``None``: the SSD kernel on a
    card)."""
    x = _embed(cfg, params, tokens)
    prefix_caches = {}
    for i in range(cfg.first_dense_layers):
        x, c = layer_forward(cfg, params["prefix"][f"p{i}"], x, i,
                             use_kernel=use_kernel)
        prefix_caches[f"p{i}"] = c
    npfx = cfg.first_dense_layers
    per_block = []
    for bi in range(n_scan_blocks(cfg)):
        bp = _index(params["blocks"], bi)
        caches = {}
        for i in range(cfg.block_period):
            l = npfx + bi * cfg.block_period + i
            x, caches[f"s{i}"] = layer_forward(cfg, bp[f"s{i}"], x, l,
                                               use_kernel=use_kernel)
        per_block.append(caches)
    logits = _logits(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"prefix": prefix_caches, "blocks": _stack(per_block)}


def forward_decode(cfg: ModelConfig, params, token, pos, caches):
    """token: (B, 1) int; pos: int; caches from ``cache_shapes`` (or a
    prefill). Returns (logits (B, Vp), new caches, stacked as given)."""
    x = _embed(cfg, params, token)
    npfx = cfg.first_dense_layers
    prefix_deltas = {}
    for i in range(npfx):
        x, prefix_deltas[f"p{i}"] = layer_decode(
            cfg, params["prefix"][f"p{i}"], x, i, pos=pos,
            cache=caches["prefix"][f"p{i}"])
    per_block = []
    for bi in range(n_scan_blocks(cfg)):
        bp = _index(params["blocks"], bi)
        bc = _index(caches["blocks"], bi)
        deltas = {}
        for i in range(cfg.block_period):
            l = npfx + bi * cfg.block_period + i
            x, deltas[f"s{i}"] = layer_decode(cfg, bp[f"s{i}"], x, l,
                                              pos=pos, cache=bc[f"s{i}"])
        per_block.append(deltas)
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"prefix": prefix_deltas, "blocks": _stack(per_block)}


# ----------------------------------------------------------- cache decls ---

def _layer_cache_shape(cfg: ModelConfig, l: int, batch: int, seq: int):
    kind = cfg.layer_kind(l)
    if kind != "ssm" or cfg.is_encoder_decoder:
        raise _unported(f"cache of layer {l} of {cfg.name} ({kind!r})")
    return S.ssm_cache_shape(cfg, batch)


def cache_shapes(cfg: ModelConfig, batch: int, seq: int):
    """Tree of shapes matching forward_decode's ``caches`` argument."""
    nb = n_scan_blocks(cfg)
    out: dict[str, Any] = {"prefix": {}, "blocks": {}}
    for i in range(cfg.first_dense_layers):
        out["prefix"][f"p{i}"] = _layer_cache_shape(cfg, i, batch, seq)
    for i in range(cfg.block_period):
        l = cfg.first_dense_layers + i
        per = _layer_cache_shape(cfg, l, batch, seq)
        out["blocks"][f"s{i}"] = {k: (nb,) + v for k, v in per.items()}
    return out


def zeros_caches(shapes, dtype=torch.bfloat16, device=None):
    """Zero tensors of ``cache_shapes``'s tree."""
    if isinstance(shapes, dict):
        return {k: zeros_caches(v, dtype, device) for k, v in shapes.items()}
    return torch.zeros(shapes, dtype=dtype, device=device)


# -------------------------------------------------------------- counting ---

def count_model_params(cfg: ModelConfig) -> int:
    return count_params(model_defs(cfg))
