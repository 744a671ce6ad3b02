"""Sharded stand-ins for every model input of a dry-run cell: the JAX
package's ``launch/inputs.py`` (its ``ShapeDtypeStruct`` stand-ins) as
DTensors that hold no memory.

Each leaf is a DTensor of the input's global shape and dtype, placed on
the mesh by the JAX package's sharding plan (``distrib.sharding``), whose
local tensor is a fake tensor at rank 0's shard shape. Build them inside
a ``FakeTensorMode`` (as ``launch.dryrun.run_cell`` does): outside one
they would allocate, so they raise. Dtypes are JAX's: parameters per
``ParamDef``, the optimizer's ``m``/``v`` in ``OptConfig.state_dtype``
with a 0-d int32 ``step``, int32 tokens and labels, bf16 encoder and
image embeddings and caches.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.distrib import sharding as SH
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptConfig


def shard_shape(shape, spec, sizes: dict[str, int]) -> tuple[int, ...]:
    """Rank 0's shard of ``shape`` under ``spec``; the plan shards only
    dimensions its mesh axes divide, so every shard is the same."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        ways = math.prod(sizes[a] for a in axes)
        if d % ways:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes}")
        out.append(d // ways)
    return tuple(out)


def leaf(shape, dtype, spec, mesh) -> DTensor:
    """A DTensor of global ``shape`` and ``dtype`` placed by ``spec`` on
    ``mesh``, its local tensor a fake tensor of rank 0's shard."""
    fake = torch._C._TorchDispatchModeKey.FAKE
    if torch._C._get_dispatch_mode(fake) is None:
        raise RuntimeError("build dry-run inputs inside a FakeTensorMode")
    shape = tuple(shape)
    local = torch.empty(shard_shape(shape, spec, SH.mesh_sizes(mesh)),
                        dtype=dtype, device=mesh.device_type)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, SH.placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _zip(fn, tree, specs):
    """``fn(leaf, spec)`` over a dict tree and its spec tree (a spec is a
    tuple, so it is a leaf here)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def param_structs(cfg: ModelConfig, mesh):
    specs = SH.model_param_specs(cfg, mesh)
    return _zip(lambda d, s: leaf(d.shape, d.dtype, s, mesh),
                M.model_defs(cfg), specs)


def opt_state_structs(cfg: ModelConfig, mesh, oc: OptConfig | None = None):
    oc = oc or OptConfig()
    specs = SH.model_param_specs(cfg, mesh)

    def mv():
        return _zip(lambda d, s: leaf(d.shape, oc.state_dtype, s, mesh),
                    M.model_defs(cfg), specs)
    return {"m": mv(), "v": mv(),
            "step": leaf((), torch.int32, SH.P(), mesh)}


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    bax = SH.batch_axes(SH.mesh_sizes(mesh), shape.global_batch)
    bspec = bax if bax else None
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": leaf((B, S), torch.int32, SH.P(bspec, None), mesh)}
    if shape.kind == "train":
        out["labels"] = leaf((B, S), torch.int32, SH.P(bspec, None), mesh)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = leaf((B, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16, SH.P(bspec, None, None), mesh)
    if cfg.num_image_tokens:
        out["img_embeds"] = leaf((B, cfg.num_image_tokens, cfg.d_model),
                                 torch.bfloat16, SH.P(bspec, None, None), mesh)
    return out


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    shapes = M.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    specs = SH.cache_specs(cfg, mesh, shape)
    return _zip(lambda s, p: leaf(s, torch.bfloat16, p, mesh), shapes, specs)


def input_specs(cfg_or_name, shape: ShapeConfig | str, mesh):
    """All dry-run inputs for one (arch, shape) cell: ``params``, and
    ``opt_state`` and ``batch`` (train), ``batch`` (prefill), or
    ``caches`` and ``token`` (decode)."""
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    bax = SH.batch_axes(SH.mesh_sizes(mesh), shape.global_batch)
    bspec = bax if bax else None

    out = {"params": param_structs(cfg, mesh)}
    if shape.kind == "train":
        out["opt_state"] = opt_state_structs(cfg, mesh)
        out["batch"] = batch_structs(cfg, shape, mesh)
    elif shape.kind == "prefill":
        out["batch"] = batch_structs(cfg, shape, mesh)
    else:
        out["caches"] = cache_structs(cfg, shape, mesh)
        out["token"] = leaf((shape.global_batch, 1), torch.int32,
                            SH.P(bspec, None), mesh)
        # static cross/encoder inputs for decode already live in caches
    return out
