"""Scatters with the JAX package's ``mode="drop"`` and write-order rules,
on tensors with a leading run axis.

JAX drops an out-of-range scatter index; torch raises on it, and an index
clamped into range would race a genuine write to the same place on the
card. These helpers route every suppressed write to one spare element
past the end of each run's flat copy of the target, which is then cut
off, so a suppressed write can never land on live data.

Every target ``a`` is ``(B, ...)``: B runs, each an independent copy of
the JAX package's array. Indices are ``(B, n)`` flat indices into one
run's elements, so run b's write i lands at ``b * a[0].numel() +
idx[b, i]`` and never in another run.
"""
from __future__ import annotations

import torch


def _flat_with_spare(a):
    B = a.shape[0]
    return torch.cat([a.reshape(B, -1), a.new_zeros((B, 1))], dim=1)


def _target(idx, keep, n):
    return torch.where(keep, idx.long(), n)


def set_drop(a, idx, vals, keep):
    """``a[b].flat[idx[b, i]] = vals[b, i]`` where ``keep[b, i]``; other
    writes vanish.

    ``idx`` holds ``(B, n)`` per-run flat indices into ``a`` (any integer
    dtype), ``keep`` is bool of the same shape, ``vals`` a tensor of that
    shape and of ``a``'s dtype, on ``a``'s device (a Python scalar would
    be copied from the host, a sync inside the slot loop). Kept indices
    of one run must be distinct (or carry equal values), as in every
    caller. Returns a new tensor shaped like ``a``."""
    n = a[0].numel()
    flat = _flat_with_spare(a)
    flat.scatter_(1, _target(idx, keep, n), vals)
    return flat[:, :n].reshape(a.shape)


def _reduce_drop(a, idx, vals, keep, reduce: str):
    n = a[0].numel()
    flat = _flat_with_spare(a)
    flat.scatter_reduce_(1, _target(idx, keep, n), vals, reduce,
                         include_self=True)
    return flat[:, :n].reshape(a.shape)


def amax_drop(a, idx, vals, keep):
    """``a[b].flat[idx[b, i]] = max(that, vals[b, i])`` where ``keep[b, i]``
    (JAX ``.at[idx].max(vals, mode="drop")`` with the dropped writes
    named by ``~keep``). Returns a new tensor shaped like ``a``."""
    return _reduce_drop(a, idx, vals, keep, "amax")


def amin_drop(a, idx, vals, keep):
    """``a[b].flat[idx[b, i]] = min(that, vals[b, i])`` where ``keep[b, i]``
    (JAX ``.at[idx].min(vals, mode="drop")``)."""
    return _reduce_drop(a, idx, vals, keep, "amin")


def add_drop(a, idx, vals, keep):
    """``a[b].flat[idx[b, i]] += vals[b, i]`` where ``keep[b, i]`` (JAX
    ``.at[idx].add(vals, mode="drop")``)."""
    return _reduce_drop(a, idx, vals, keep, "sum")


def last_writer(idx):
    """``(B, n)`` bool: True where no later position of the same run
    writes the same index.

    A JAX ``.at[idx].set(vals)`` on the CPU applies its updates in order,
    so among duplicate indices the last one wins. Keeping only those
    writes gives the same result on any device, in any write order. The
    comparison is per run, ``(B, n, n)``, never across runs."""
    n = idx.shape[-1]
    later = torch.ones(n, n, dtype=torch.bool, device=idx.device).triu_(1)
    return ~((idx[:, :, None] == idx[:, None, :]) & later).any(dim=2)


__all__ = ["set_drop", "amax_drop", "amin_drop", "add_drop", "last_writer"]
