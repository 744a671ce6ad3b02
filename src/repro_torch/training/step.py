"""train_step / prefill_step / serve_step builders: the JAX package's
``training/step.py`` on tensor trees.

``build_train_step`` returns a plain callable (params, opt_state, batch)
-> (params, opt_state, metrics) on tensors, with microbatch gradient
accumulation and remat. Gradients come from ``torch.autograd`` over the
plain path (``models.model.loss_fn``), as JAX's come from
``jax.value_and_grad``. The step runs eagerly and reads nothing back to
the host.

Without a mesh the step runs in one process on one device and
``choose_grad_accum`` sees one device, ``{"data": 1}``; the
data-parallel step is ``distrib.homa_collectives.build_dp_train_step``.
With a mesh and a shape (the dry run, ``launch.dryrun``), as in JAX,
``choose_grad_accum`` sees the mesh's sizes and the model gets
``activation_shardings`` for its ``cst`` hooks: the step then runs on
DTensors placed by ``distrib.sharding``'s plan. ``attn_dp=False`` drops
the plan's data-parallel attention region ("attn_qkv"), the JAX
package's ``REPRO_ATTN_DP=0``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distrib import sharding as SH
from repro_torch.distrib.sharding import batch_axes
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.tree import flatten, tree_map, unflatten

F32 = torch.float32


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


def _shardings(cfg, mesh, shape, attn_dp: bool, **kw):
    """The model's activation specs on ``mesh`` (None without one)."""
    if mesh is None or shape is None:
        return None
    sh = SH.activation_shardings(cfg, mesh, shape, **kw)
    if not attn_dp:
        sh["attn_qkv"] = None
    return sh


def _split(x, n: int) -> list:
    """``x`` cut into ``n`` microbatches along its batch dimension. A
    DTensor is cut shard by shard (``distrib.sharding.split_local``), so
    each microbatch stays on the batch's devices: it holds every shard's
    i-th part, not the batch's i-th contiguous part. The step's gradient
    of a mean over tokens is the same either way; the MoE's
    load-balancing term depends on which tokens share a microbatch."""
    if isinstance(x, DTensor):
        return SH.split_local(x, n)
    return list(x.reshape((n, x.shape[0] // n) + x.shape[1:]).unbind(0))


def _synced(grads, params):
    """Gradients over DTensors reduced once into their parameters'
    layouts (the data-parallel sync: an all-reduce, or FSDP's
    reduce-scatter where the parameter is sharded); others as they
    are."""
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if isinstance(g, DTensor) else g, grads, params)


def build_train_step(cfg: ModelConfig, oc: OptConfig, *, mesh=None,
                     shape: ShapeConfig | None = None,
                     grad_accum: int | None = None, remat: bool = True,
                     accum_dtype=F32, attn_dp: bool = True):
    """The step for ``grad_accum`` microbatches (chosen from ``shape`` for
    ``mesh``, or for one device without one, when not given; 1 without
    a shape). With one, the gradients reach AdamW in the parameters'
    dtype, as ``jax.value_and_grad`` gives them; with more, they are
    summed in ``accum_dtype`` and divided by ``grad_accum``. ``metrics``
    holds "loss", "grad_norm" and "lr"."""
    if grad_accum is None and shape is not None:
        sizes = SH.mesh_sizes(mesh) if mesh is not None else {"data": 1}
        grad_accum = choose_grad_accum(cfg, shape, sizes)
    grad_accum = grad_accum or 1
    shardings = _shardings(cfg, mesh, shape, attn_dp, grad_accum=grad_accum)

    def micro_loss(params, mb):
        return M.loss_fn(cfg, params, mb, remat=remat,
                         shardings=shardings)[0]

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, _, grads = value_and_grad(micro_loss, params, batch)
            grads = _synced(grads, params)
        else:
            micro = {k: _split(v, grad_accum) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype, memory_format=torch.contiguous_format),
                params)
            loss = None
            for i in range(grad_accum):
                l, _, g = value_and_grad(
                    micro_loss, params, {k: v[i] for k, v in micro.items()})
                g = _synced(g, params)
                for a, b in zip(flatten(grads), flatten(g)):
                    a.add_(b.to(accum_dtype))
                loss = l if loss is None else loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, oc)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step


def build_prefill_step(cfg: ModelConfig, *, mesh=None,
                       shape: ShapeConfig | None = None,
                       use_kernel: bool | None = None, attn_dp: bool = True):
    """(params, batch) -> (last-token logits, caches); ``use_kernel`` goes
    to ``forward_prefill`` (None: the kernels on a card). The batch's
    ``enc_embeds`` / ``img_embeds``, where it has them, go to the encoder
    and the cross layers. With ``mesh`` and ``shape``, the model gets
    their activation specs."""
    shardings = _shardings(cfg, mesh, shape, attn_dp)

    def prefill_step(params, batch):
        return M.forward_prefill(cfg, params, batch["tokens"],
                                 enc_embeds=batch.get("enc_embeds"),
                                 img_embeds=batch.get("img_embeds"),
                                 use_kernel=use_kernel, shardings=shardings)

    return prefill_step


def build_serve_step(cfg: ModelConfig, *, pos: int | None = None,
                     use_kernel: bool | None = None):
    """One-token decode at ``pos``, or at the step's ``position``
    argument when ``pos`` is None; ``use_kernel`` goes to
    ``forward_decode``."""

    def serve_step(params, caches, token, position):
        p = pos if pos is not None else position
        return M.forward_decode(cfg, params, token, p, caches,
                                use_kernel=use_kernel)

    return serve_step
