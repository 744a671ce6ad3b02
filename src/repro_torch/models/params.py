"""Parameter definitions: one source of truth for shape, init and dtype.

A model is described as a tree (nested dicts) of ``ParamDef`` leaves, as
in the JAX package. From that tree the port derives materialized
parameters (``init_params``) and parameter counts (``count_params``).
The logical sharding axes are kept on each definition so the trees read
the same in both packages; the port runs on one card and does not read
them (``param_specs``/``param_shapes`` serve TPU meshes: ROADMAP A11).
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
