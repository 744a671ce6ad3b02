"""Parameter definitions: one source of truth for shape, init and dtype.

A model is described as a tree (nested dicts) of ``ParamDef`` leaves, as
in the JAX package. From that tree the port derives materialized
parameters (``init_params``), parameter counts (``count_params``), the
matching ``PartitionSpec`` tree (``param_specs``) and stand-ins that hold
no memory for dry runs (``param_shapes``).

Sharding axes are *logical* names resolved against the physical mesh at spec
build time. A dimension is sharded only when divisible by the product of the
mapped mesh axes; otherwise it silently falls back to replication for that
dimension (small models on big meshes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | scaled
    scale: float = 1.0          # stddev multiplier (for normal/scaled)
    fan_in: int | None = None   # for "scaled": stddev = scale / sqrt(fan_in)
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(fn: Callable[[ParamDef], Any], tree: Tree) -> Tree:
    if is_def(tree):
        return fn(tree)
    return {k: tree_map_defs(fn, v) for k, v in tree.items()}


def leaves(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in sorted key order (the order of
    ``jax.tree.flatten`` over dicts), paths joined with ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def stack_defs(tree: Tree, n: int) -> Tree:
    """Add a leading stacked-layer dimension to every def in the tree."""
    def add(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, shape=(n,) + d.shape,
                                   axes=("stack",) + d.axes)
    return tree_map_defs(add, tree)


def _resolve_axis(logical: str | None, dim: int, rules: dict[str, tuple[str, ...]],
                  mesh_sizes: dict[str, int]):
    """Map a logical axis to mesh axes, dropping it if not divisible."""
    if logical is None:
        return None
    mesh_axes = rules.get(logical, ())
    if not mesh_axes:
        return None
    size = math.prod(mesh_sizes[a] for a in mesh_axes)
    if size <= 1 or dim % size != 0:
        return None
    return mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]


def param_specs(tree: Tree, rules: dict[str, tuple[str, ...]],
                mesh_sizes: dict[str, int]) -> Tree:
    """The ``PartitionSpec`` of every def (``distrib.sharding``'s type)."""
    from repro_torch.distrib.sharding import PartitionSpec as P

    def spec(d: ParamDef):
        used: set[str] = set()
        out = []
        for a, s in zip(d.axes, d.shape):
            r = _resolve_axis(a, s, rules, mesh_sizes)
            names = (r,) if isinstance(r, str) else (r or ())
            if r is None or any(n in used for n in names):
                out.append(None)  # a mesh axis may appear at most once per spec
            else:
                used.update(names)
                out.append(r)
        return P(*out)
    return tree_map_defs(spec, tree)


def param_shapes(tree: Tree, device="meta") -> Tree:
    """Empty tensors of each def's shape and dtype on ``device``: "meta",
    or any device inside a ``FakeTensorMode``; neither allocates."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device=device), tree)


def count_params(tree: Tree) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(tree))


def _make(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "scaled":
        fan = d.fan_in if d.fan_in is not None else (
            d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        std = d.scale / math.sqrt(max(fan, 1))
    else:  # normal
        std = 0.02 * d.scale
    w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(device=device, dtype=d.dtype)


def init_params(tree: Tree, generator: torch.Generator, device) -> Tree:
    """Materialize parameters on ``device``, drawing the leaves from
    ``generator`` in sorted key order. The JAX package's init has the same
    distributions but other numbers (its keys are not a torch generator);
    to run both on one set of weights, carry the JAX tree across with
    :func:`repro_torch.convert.params_from_jax`."""
    if is_def(tree):
        return _make(tree, generator, device)
    return {k: init_params(tree[k], generator, device) for k in sorted(tree)}
