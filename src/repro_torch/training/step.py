"""train_step / prefill_step / serve_step builders: the JAX package's
``training/step.py`` on tensor trees.

``build_train_step`` returns a plain callable (params, opt_state, batch)
-> (params, opt_state, metrics) on tensors, with microbatch gradient
accumulation and remat. Gradients come from ``torch.autograd`` over the
plain path (``models.model.loss_fn``), as JAX's come from
``jax.value_and_grad``. The step runs eagerly and reads nothing back to
the host.

The step runs in one process on one device: where JAX takes a mesh to
choose the microbatch count, the builder takes only the shape, and
``choose_grad_accum`` sees one device, ``{"data": 1}``. The
data-parallel step is ``distrib.homa_collectives.build_dp_train_step``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.tree import flatten, tree_map, unflatten

F32 = torch.float32


def batch_axes(sizes: dict[str, int], global_batch: int):
    """Mesh axes to shard the batch over (largest divisible prefix of
    (pod, data)); the JAX package's ``distrib/sharding.py`` rule."""
    axes = [a for a in ("pod", "data") if a in sizes]
    total = 1
    used = []
    for a in axes:
        if global_batch % (total * sizes[a]) == 0:
            used.append(a)
            total *= sizes[a]
    return tuple(used)


def choose_grad_accum(cfg: ModelConfig, shape: ShapeConfig,
                      sizes: dict[str, int]) -> int:
    """Microbatch count: keep per-device microbatch tokens bounded."""
    bax = batch_axes(sizes, shape.global_batch)
    shards = math.prod(sizes[a] for a in bax) if bax else 1
    per_dev = shape.global_batch // shards
    target_tokens = 8192 if cfg.d_model >= 8192 else 16384
    want = max(1, (per_dev * shape.seq_len) // target_tokens)
    # largest divisor of per_dev not exceeding want
    return max(a for a in range(1, per_dev + 1)
               if per_dev % a == 0 and a <= want)


def value_and_grad(fn, params, *args, has_aux: bool = False):
    """``jax.value_and_grad(fn, has_aux=...)(params, *args)`` by autograd:
    returns (value, aux, grads) with aux None unless ``has_aux``, and
    grads a tree like ``params``, each leaf in its parameter's dtype (zero
    where the value does not depend on it). Nothing is left attached to
    the graph."""
    leaves = [p.detach().requires_grad_() for p in flatten(params)]
    with torch.enable_grad():
        out = fn(unflatten(params, leaves), *args)
        value, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                    materialize_grads=True)
    if aux is not None:
        aux = tree_map(torch.Tensor.detach, aux)
    return value.detach(), aux, unflatten(params, list(grads))


def build_train_step(cfg: ModelConfig, oc: OptConfig, *,
                     shape: ShapeConfig | None = None,
                     grad_accum: int | None = None, remat: bool = True,
                     accum_dtype=F32):
    """The step for ``grad_accum`` microbatches (chosen from ``shape`` for
    one device when not given; 1 without either). With one, the
    gradients reach AdamW in the parameters' dtype, as
    ``jax.value_and_grad`` gives them; with more, they are summed in
    ``accum_dtype`` and divided by ``grad_accum``. ``metrics`` holds
    "loss", "grad_norm" and "lr"."""
    if grad_accum is None and shape is not None:
        grad_accum = choose_grad_accum(cfg, shape, {"data": 1})
    grad_accum = grad_accum or 1

    def micro_loss(params, mb):
        return M.loss_fn(cfg, params, mb, remat=remat)[0]

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, _, grads = value_and_grad(micro_loss, params, batch)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = None
            for i in range(grad_accum):
                l, _, g = value_and_grad(
                    micro_loss, params, {k: v[i] for k, v in micro.items()})
                for a, b in zip(flatten(grads), flatten(g)):
                    a.add_(b.to(accum_dtype))
                loss = l if loss is None else loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, oc)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def build_prefill_step(cfg: ModelConfig):
    """(params, batch) -> (last-token logits, caches); the mixers take the
    kernels on a card (``forward_prefill``'s default). The batch's
    ``enc_embeds`` / ``img_embeds``, where it has them, go to the encoder
    and the cross layers."""

    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch["tokens"],
                                 enc_embeds=batch.get("enc_embeds"),
                                 img_embeds=batch.get("img_embeds"))

    return prefill_step


def build_serve_step(cfg: ModelConfig, *, pos: int | None = None):
    """One-token decode at ``pos``, or at the step's ``position``
    argument when ``pos`` is None."""

    def serve_step(params, caches, token, position):
        p = pos if pos is not None else position
        return M.forward_decode(cfg, params, token, p, caches)

    return serve_step
