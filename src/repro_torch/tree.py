"""Trees of tensors: nested dicts, tuples and lists with tensor leaves.

The port's counterpart of ``jax.tree``. Leaves come in the order
``jax.tree.flatten`` gives them: a dict's keys sorted, a tuple's or a
list's items in turn. So a parameter tree, an optimizer state or a
``(params, opt_state)`` pair lists its leaves in the same order in both
packages, which the checkpoint format, the global norm's sum and the
gradient-sync plan all rely on.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def flatten(tree: Tree) -> list:
    """The tree's leaves, in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten(t)]
    return [tree]


def unflatten(like: Tree, leaves: list) -> Tree:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree has") from None

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to trees of one structure."""
    cols = [flatten(t) for t in (tree, *rest)]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def paths(tree: Tree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's key path (dict keys and sequence indices), in flatten
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree) for p in paths(t, prefix + (i,))]
    return [prefix]
