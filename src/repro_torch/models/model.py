"""Model assembly: the JAX package's ``models/model.py``. A decoder's
layers are ``ssm`` (Mamba2), ``attn`` (GQA self-attention or MLA) or
``cross`` (cross-attention to image embeddings) mixers with an optional
dense MLP or MoE; an encoder-decoder (Whisper) adds an encoder stack
over precomputed frame embeddings and, in every decoder layer, a
cross-attention to the encoder's output after the mixer.

Entrypoints
-----------
- ``model_defs(cfg)``        -> ParamDef tree (single source of truth)
- ``forward_train(...)``     -> (logits over the full sequence, aux loss)
- ``forward_prefill(...)``   -> (last-token logits, caches)
- ``forward_decode(...)``    -> (logits, new caches) for one token
- ``loss_fn(...)``           -> (scalar LM loss, its parts)
- ``cache_shapes(cfg, ...)`` -> tree of cache shapes for decode
- ``count_model_params(cfg)``/``active_params(cfg)``

Parameters and caches keep the JAX package's stacked layout: every leaf
under ``blocks`` carries a leading block axis ``nb`` (``blocks/s0/...``).
Where JAX runs ``lax.scan`` over that axis, the port loops over the
blocks in Python, so a tree carried across from JAX
(:func:`repro_torch.convert.params_from_jax`) is used as it is.

The encoder's input (``enc_embeds``, (B, encoder_seq, D)) and the image
embeddings (``img_embeds``, (B, num_image_tokens, D)) are given by the
caller, as in the JAX package, whose conv front end and vision tower are
stubs. The prefill keeps their K/V in the cache: ``{"k", "v"}`` of the
image in a cross layer, ``"xk"``/``"xv"`` of the encoder's output in
every decoder layer of an encoder-decoder. A decode step reads them and,
as JAX's, returns no delta for them (``{}`` for a cross layer).

Training differentiates the plain path with ``torch.autograd``, as the
JAX package differentiates its plain path with ``jax.value_and_grad``:
``forward_train`` runs every mixer with ``use_kernel=False``, since the
hand-written kernels have no backward (ROADMAP C2) and JAX's training
path calls neither Pallas kernel. Its aux loss is the sum of the MoE
layers' load-balancing losses, as in JAX.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import ParamDef, count_params, stack_defs

F32 = torch.float32


def cst(x, shardings, key):
    """The JAX package's ``with_sharding_constraint`` hook: ``x``
    redistributed to the spec for ``key`` when one was given and ``x`` is
    a DTensor; otherwise ``x`` itself."""
    spec = shardings.get(key) if shardings else None
    if spec is None:
        return x
    from repro_torch.distrib.sharding import constrain
    return constrain(x, spec)


# ------------------------------------------------------------- defs tree ---

def layer_defs(cfg: ModelConfig, l: int):
    kind = cfg.layer_kind(l)
    d: dict[str, Any] = {"norm1": L.norm_defs(cfg)}
    if kind == "attn":
        d["mixer"] = L.mla_defs(cfg) if cfg.use_mla else L.attn_defs(cfg)
    elif kind == "ssm":
        d["mixer"] = S.ssm_defs(cfg)
    elif kind == "cross":
        d["mixer"] = L.cross_attn_defs(cfg)
    if cfg.is_encoder_decoder:
        d["norm_x"] = L.norm_defs(cfg)
        d["xattn"] = L.cross_attn_defs(cfg)
    if cfg.d_ff > 0 or cfg.is_moe_layer(l):
        d["norm2"] = L.norm_defs(cfg)
        d["ffn"] = L.moe_defs(cfg) if cfg.is_moe_layer(l) else L.mlp_defs(cfg)
    return d


def encoder_layer_defs(cfg: ModelConfig):
    return {"norm1": L.norm_defs(cfg), "mixer": L.attn_defs(cfg),
            "norm2": L.norm_defs(cfg), "ffn": L.mlp_defs(cfg)}


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
    if cfg.is_encoder_decoder:
        defs["encoder"] = {
            "blocks": stack_defs(encoder_layer_defs(cfg), cfg.encoder_layers),
            "final_norm": L.norm_defs(cfg),
        }
    return defs


def n_scan_blocks(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_dense_layers) // cfg.block_period


def _index(tree, i: int):
    """Block ``i`` of a stacked tree (every leaf's leading axis)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` blocks of a stacked tree, each leaf split by one
    ``torch.unbind`` (whose backward stacks the blocks' gradients once,
    where indexing block by block would scatter each into a zero tensor
    of the stacked shape)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list):
    """Stack per-block trees along a new leading axis (``lax.scan``'s
    stacked outputs)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# --------------------------------------------------------- layer forward ---

def _ffn(cfg, lp, x, moe_layer: bool = False, shardings=None):
    """The layer's FFN with its residual: (x, aux), aux the MoE's
    load-balancing loss (a zero fp32 scalar for a dense MLP)."""
    h = L.apply_norm(cfg, lp["norm2"], x)
    if moe_layer:
        spec = shardings.get("moe_dispatch") if shardings else None
        y, aux = L.moe(cfg, lp["ffn"], h, dispatch_spec=spec)
        return x + y, aux
    return (x + L.mlp(cfg, lp["ffn"], h),
            torch.zeros((), dtype=F32, device=x.device))


def layer_forward(cfg: ModelConfig, lp, x, l: int, *, mode: str = "prefill",
                  use_kernel: bool | None = None, enc_out=None,
                  img_embeds=None, shardings=None):
    """One layer, full sequence from position 0. Returns (x, new_cache,
    aux), aux the layer's MoE load-balancing loss (0 without one).

    ``mode="prefill"`` keeps the layer's cache and passes ``use_kernel``
    to the mixer (``self_attention``, ``mla_attention``,
    ``cross_attention`` or ``mamba_block``) and to an encoder-decoder's
    cross-attention; ``mode="train"`` keeps none ({}) and runs the
    plain paths, which autograd can differentiate (the kernels have no
    backward). A cross layer attends to ``img_embeds``' K/V; every layer
    of an encoder-decoder attends, after its mixer, to ``enc_out``'s.
    ``shardings`` (``distrib.sharding.activation_shardings``) pins the
    residual, the K/V cache, the attention's q/k/v and the MoE's
    dispatch buffer where the JAX package does; None leaves every tensor
    as it is."""
    kind = cfg.layer_kind(l)
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    train = mode == "train"
    if train:
        if use_kernel:
            raise ValueError("mode='train' runs the plain mixers: the "
                             "kernels have no backward")
        use_kernel = False
    h = L.apply_norm(cfg, lp["norm1"], x)
    new_cache = {}
    aux = torch.zeros((), dtype=F32, device=x.device)
    if kind == "attn" and cfg.use_mla:
        positions = torch.arange(x.shape[1], device=x.device)
        y, (ckv, kr) = L.mla_attention(cfg, lp["mixer"], h, positions,
                                       use_kernel=use_kernel)
        if not train:
            new_cache = {"ckv": ckv, "kr": kr}
    elif kind == "attn":
        positions = torch.arange(x.shape[1], device=x.device)
        y, (k, v) = L.self_attention(cfg, lp["mixer"], h, positions,
                                     window=cfg.sliding_window,
                                     use_kernel=use_kernel,
                                     shardings=shardings)
        if not train:
            if cfg.sliding_window:   # ring cache: keep last `window`
                w = min(cfg.sliding_window, k.shape[1])
                k, v = k[:, -w:], v[:, -w:]
            new_cache = {"k": cst(k, shardings, "kv_cache"),
                         "v": cst(v, shardings, "kv_cache")}
    elif kind == "ssm":
        y, (final_state, conv_tail) = S.mamba_block(cfg, lp["mixer"], h,
                                                    use_kernel=use_kernel)
        if not train:
            new_cache = {"state": final_state.to(x.dtype),
                         "conv": conv_tail.to(x.dtype)}
    else:
        kv = L.cross_kv(cfg, lp["mixer"], img_embeds)
        y = L.cross_attention(cfg, lp["mixer"], h, kv, use_kernel=use_kernel)
        if not train:
            new_cache = kv
    x = x + y
    if cfg.is_encoder_decoder:
        hx = L.apply_norm(cfg, lp["norm_x"], x)
        kv = L.cross_kv(cfg, lp["xattn"], enc_out)
        x = x + L.cross_attention(cfg, lp["xattn"], hx, kv,
                                  use_kernel=use_kernel)
        if not train:
            new_cache["xk"], new_cache["xv"] = kv["k"], kv["v"]
    if "ffn" in lp:
        x, aux = _ffn(cfg, lp, x, cfg.is_moe_layer(l), shardings)
    return cst(x, shardings, "residual"), new_cache, aux


def layer_decode(cfg: ModelConfig, lp, x, l: int, *, pos, cache,
                 use_kernel: bool | None = None, shardings=None):
    """One layer, one token. Returns (x, cache_delta): the new token's
    K/V (or latent, or SSM state); ``{}`` for a cross layer, and no
    ``xk``/``xv``, whose K/V do not change. ``use_kernel`` goes to the
    cross-attention, the step's one kernel call site."""
    kind = cfg.layer_kind(l)
    h = L.apply_norm(cfg, lp["norm1"], x)
    delta = {}
    if kind == "attn" and cfg.use_mla:
        y, (ckv, kr) = L.mla_attention_decode(cfg, lp["mixer"], h, pos,
                                              cache)
        delta = {"ckv": ckv, "kr": kr}
    elif kind == "attn":
        y, (kn, vn) = L.self_attention_decode(
            cfg, lp["mixer"], h, pos, cache, window=cfg.sliding_window)
        delta = {"k": kn, "v": vn}
    elif kind == "ssm":
        y, delta = S.mamba_block_decode(cfg, lp["mixer"], h, cache)
    else:
        y = L.cross_attention(cfg, lp["mixer"], h,
                              {"k": cache["k"], "v": cache["v"]},
                              use_kernel=use_kernel)
    x = x + y
    if cfg.is_encoder_decoder:
        hx = L.apply_norm(cfg, lp["norm_x"], x)
        x = x + L.cross_attention(cfg, lp["xattn"], hx,
                                  {"k": cache["xk"], "v": cache["xv"]},
                                  use_kernel=use_kernel)
    if "ffn" in lp:
        x, _ = _ffn(cfg, lp, x, cfg.is_moe_layer(l), shardings)
    return x, delta


# ----------------------------------------------------------- full stacks ---

def _embed(cfg, params, tokens, shardings=None):
    w = params["embed"]
    if isinstance(w, DTensor):
        # DTensor's rule for an embedding lookup gathers from a
        # vocab-sharded table locally (masked partial sums, the same values
        # as indexing), which are summed here, before their first use
        from repro_torch.distrib.sharding import settle
        x = torch.nn.functional.embedding(tokens, w)
        return cst(settle(x), shardings, "residual")
    return w[tokens]


def _logits(cfg, params, x, shardings=None):
    x = L.apply_norm(cfg, params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = L._proj("bsd,dv->bsv", x, w)
    logits = cst(logits, shardings, "logits")
    # mask padded vocab entries
    Vp = cfg.padded_vocab()
    if Vp != cfg.vocab_size:
        mask = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full((), -1e9, dtype=F32,
                                                      device=logits.device))
    return logits


def _check_inputs(cfg: ModelConfig, enc_embeds, img_embeds) -> None:
    """Raise unless the model's encoder or image input is given."""
    if cfg.is_encoder_decoder and enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         f"enc_embeds (B, {cfg.encoder_seq}, {cfg.d_model})")
    if img_embeds is None and any(cfg.layer_kind(l) == "cross"
                                  for l in range(cfg.num_layers)):
        raise ValueError(f"{cfg.name} cross-attends to images: pass "
                         f"img_embeds (B, {cfg.num_image_tokens}, "
                         f"{cfg.d_model})")


def encoder_forward(cfg: ModelConfig, params, enc_embeds, *,
                    use_kernel: bool | None = None, shardings=None):
    """The encoder of an encoder-decoder over ``enc_embeds`` (B, Se, D):
    each layer a pre-norm, rope'd self-attention over positions 0..Se-1
    that masks nothing (``L.full_attention``: the kernel on a card unless
    ``use_kernel=False``) and an MLP; then the encoder's final norm.
    Returns (B, Se, D) in enc_embeds' dtype."""
    ep = params["encoder"]
    x = enc_embeds
    pos = torch.arange(x.shape[1], device=x.device)
    cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    for bp in _unstack(ep["blocks"], cfg.encoder_layers):
        h = L.apply_norm(cfg, bp["norm1"], x)
        q, k, v = L._qkv(cfg, bp["mixer"], h)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        y = L.full_attention(q, k, v, use_kernel=use_kernel)
        x = x + L._proj("bshk,hkd->bsd", y, bp["mixer"]["wo"]).to(x.dtype)
        x = x + L.mlp(cfg, bp["ffn"], L.apply_norm(cfg, bp["norm2"], x))
        x = cst(x, shardings, "residual")
    return L.apply_norm(cfg, ep["final_norm"], x)


def forward_train(cfg: ModelConfig, params, tokens, *, enc_embeds=None,
                  img_embeds=None, remat: bool = True, shardings=None):
    """tokens: (B, S) -> (logits (B, S, Vp) fp32, aux loss).

    Every layer runs in ``mode="train"`` (plain paths, no caches), the
    encoder too (``use_kernel=False``). ``remat=True`` recomputes each
    stacked block in the backward pass (``torch.utils.checkpoint``, the
    JAX package's ``jax.checkpoint``), so only the blocks' inputs are
    kept; the encoder is not recomputed, as in JAX. ``aux`` is the fp32
    sum of the MoE layers' load-balancing losses, prefix first and then
    block by block, in JAX's order (zero without MoE layers).
    ``shardings`` as in ``layer_forward``."""
    _check_inputs(cfg, enc_embeds, img_embeds)
    x = _embed(cfg, params, tokens, shardings)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encoder_forward(cfg, params, enc_embeds, use_kernel=False,
                                  shardings=shardings)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(cfg.first_dense_layers):
        x, _, a = layer_forward(cfg, params["prefix"][f"p{i}"], x, i,
                                mode="train", enc_out=enc_out,
                                img_embeds=img_embeds, shardings=shardings)
        aux = aux + a
    npfx, period = cfg.first_dense_layers, cfg.block_period

    def block_fn(x, aux, bp, bi, enc_out, img_embeds):
        for i in range(period):
            x, _, a = layer_forward(cfg, bp[f"s{i}"], x,
                                    npfx + bi * period + i, mode="train",
                                    enc_out=enc_out, img_embeds=img_embeds,
                                    shardings=shardings)
            aux = aux + a
        return x, aux

    for bi, bp in enumerate(_unstack(params["blocks"], n_scan_blocks(cfg))):
        if remat:
            x, aux = checkpoint(block_fn, x, aux, bp, bi, enc_out,
                                img_embeds, use_reentrant=False)
        else:
            x, aux = block_fn(x, aux, bp, bi, enc_out, img_embeds)
    return _logits(cfg, params, x, shardings), aux


def forward_prefill(cfg: ModelConfig, params, tokens, *, enc_embeds=None,
                    img_embeds=None, use_kernel: bool | None = None,
                    shardings=None):
    """tokens: (B, S) -> (logits for last position (B, Vp), caches tree).

    Cache leaves are stacked over blocks: (nb, B, ...). ``use_kernel``
    goes to every layer's mixer and cross-attention and to the encoder
    (``None``: the SSD or flash-attention kernel on a card).
    ``shardings`` as in ``layer_forward``."""
    _check_inputs(cfg, enc_embeds, img_embeds)
    x = _embed(cfg, params, tokens, shardings)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encoder_forward(cfg, params, enc_embeds,
                                  use_kernel=use_kernel, shardings=shardings)
    kw = dict(use_kernel=use_kernel, enc_out=enc_out, img_embeds=img_embeds,
              shardings=shardings)
    prefix_caches = {}
    for i in range(cfg.first_dense_layers):
        x, c, _ = layer_forward(cfg, params["prefix"][f"p{i}"], x, i, **kw)
        prefix_caches[f"p{i}"] = c
    npfx = cfg.first_dense_layers
    per_block = []
    for bi in range(n_scan_blocks(cfg)):
        bp = _index(params["blocks"], bi)
        caches = {}
        for i in range(cfg.block_period):
            l = npfx + bi * cfg.block_period + i
            x, caches[f"s{i}"], _ = layer_forward(cfg, bp[f"s{i}"], x, l,
                                                  **kw)
        per_block.append(caches)
    logits = _logits(cfg, params, x[:, -1:, :], shardings)[:, 0]
    return logits, {"prefix": prefix_caches, "blocks": _stack(per_block)}


def forward_decode(cfg: ModelConfig, params, token, pos, caches, *,
                   use_kernel: bool | None = None, shardings=None):
    """token: (B, 1) int; pos: int; caches from ``cache_shapes`` (or a
    prefill). Returns (logits (B, Vp), cache deltas, stacked as given:
    JAX's deltas, which carry no cross-attention K/V). ``use_kernel``
    goes to the cross-attention (``None``: the kernel on a card); self
    attention, MLA and SSM layers decode on their plain paths, as in
    JAX. ``shardings`` as in ``layer_forward``."""
    x = _embed(cfg, params, token, shardings)
    npfx = cfg.first_dense_layers
    prefix_deltas = {}
    for i in range(npfx):
        x, prefix_deltas[f"p{i}"] = layer_decode(
            cfg, params["prefix"][f"p{i}"], x, i, pos=pos,
            cache=caches["prefix"][f"p{i}"], use_kernel=use_kernel,
            shardings=shardings)
    per_block = []
    for bi in range(n_scan_blocks(cfg)):
        bp = _index(params["blocks"], bi)
        bc = _index(caches["blocks"], bi)
        deltas = {}
        for i in range(cfg.block_period):
            l = npfx + bi * cfg.block_period + i
            x, deltas[f"s{i}"] = layer_decode(cfg, bp[f"s{i}"], x, l,
                                              pos=pos, cache=bc[f"s{i}"],
                                              use_kernel=use_kernel,
                                              shardings=shardings)
        per_block.append(deltas)
    logits = _logits(cfg, params, x, shardings)[:, 0]
    return logits, {"prefix": prefix_deltas, "blocks": _stack(per_block)}


# ----------------------------------------------------------------- loss ----

def _vocab_terms(logits: DTensor, labels):
    """(logsumexp, the label's logit) over the last dimension of sharded
    logits, as JAX writes them: a max-shifted sum of exponentials and a
    one-hot masked sum, which reduce shard by shard over a vocab-sharded
    tensor (partial sums, then an all-reduce), where ``logsumexp`` would
    first gather the whole vocabulary, and ``gather``'s backward builds
    its zeros replicated, at the logits' global shape on every rank."""
    m = L.whole(logits.detach().amax(-1, keepdim=True))
    lse = torch.log(L.whole(torch.sum(torch.exp(logits - m), -1))) + m[..., 0]
    vocab = torch.arange(logits.shape[-1], device=labels.device)
    ll = L.whole(torch.sum(torch.where(vocab == labels[..., None], logits,
                                       0.0), -1))
    return lse, ll


def loss_fn(cfg: ModelConfig, params, batch, *, remat: bool = True,
            aux_weight: float = 0.01, z_weight: float = 1e-4,
            shardings=None):
    """The JAX package's LM loss: mean next-token NLL over labels >= 0,
    plus ``z_weight`` times the mean squared log-partition (z-loss) and
    ``aux_weight`` times the aux loss. Returns (loss, {"nll", "aux",
    "zloss"}), fp32 scalars.

    JAX picks the label's logit by a one-hot masked sum over the vocab;
    one non-zero term plus zeros sums without rounding, so the gather
    here is the same number, and builds no (B, S, Vp) one-hot."""
    logits, aux = forward_train(cfg, params, batch["tokens"],
                                enc_embeds=batch.get("enc_embeds"),
                                img_embeds=batch.get("img_embeds"),
                                remat=remat, shardings=shardings)
    labels = batch["labels"]
    mask = (labels >= 0).to(F32)
    labels = torch.clamp_min(labels, 0).long()
    if L.spread(logits):
        lse, ll = _vocab_terms(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    count = torch.clamp_min(mask.sum(), 1.0)
    nll = torch.sum((lse - ll) * mask) / count
    zloss = torch.sum((lse ** 2) * mask) / count
    loss = nll + z_weight * zloss + aux_weight * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}


# ----------------------------------------------------------- cache decls ---

def _layer_cache_shape(cfg: ModelConfig, l: int, batch: int, seq: int):
    kind = cfg.layer_kind(l)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    if kind == "attn" and cfg.use_mla:
        c = {"ckv": (batch, seq, cfg.kv_lora_rank),
             "kr": (batch, seq, cfg.rope_head_dim)}
    elif kind == "attn":
        s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        c = {"k": (batch, s, KV, hd), "v": (batch, s, KV, hd)}
    elif kind == "ssm":
        c = S.ssm_cache_shape(cfg, batch)
    else:
        c = {"k": (batch, cfg.num_image_tokens, KV, hd),
             "v": (batch, cfg.num_image_tokens, KV, hd)}
    if cfg.is_encoder_decoder:
        c["xk"] = (batch, cfg.encoder_seq, KV, hd)
        c["xv"] = (batch, cfg.encoder_seq, KV, hd)
    return c


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


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only the top-K experts)."""
    total = count_model_params(cfg)
    if not cfg.num_experts:
        return total
    E, K = cfg.num_experts, cfg.experts_per_token
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    n_moe_layers = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
    return total - n_moe_layers * per_expert * (E - K)
