"""Scatters with the JAX package's ``mode="drop"`` and write-order rules.

JAX drops an out-of-range scatter index; torch raises on it, and an index
clamped into range would race a genuine write to the same place on the
card. These helpers route every suppressed write to one spare element
past the end of a flat copy of the target, which is then cut off, so a
suppressed write can never land on live data.
"""
from __future__ import annotations

import torch


def _flat_with_spare(a):
    return torch.cat([a.reshape(-1), a.new_zeros(1)])


def set_drop(a, idx, vals, keep):
    """``a.flat[idx[i]] = vals[i]`` where ``keep[i]``; other writes vanish.

    ``idx`` holds flat indices into ``a`` (any integer dtype), ``keep`` is
    bool of the same length, ``vals`` a tensor on ``a``'s device (a Python
    scalar would be copied from the host, a sync inside the slot loop).
    Kept indices must be distinct (or carry equal values), as in every
    caller. Returns a new tensor shaped like ``a``."""
    n = a.numel()
    flat = _flat_with_spare(a)
    flat[torch.where(keep, idx.long(), n)] = vals
    return flat[:n].view(a.shape)


def amax_drop(a, idx, vals, keep):
    """``a.flat[idx[i]] = max(a.flat[idx[i]], vals[i])`` where ``keep[i]``
    (JAX ``.at[idx].max(vals, mode="drop")`` with the dropped writes
    named by ``~keep``). Returns a new tensor shaped like ``a``."""
    n = a.numel()
    flat = _flat_with_spare(a)
    flat.scatter_reduce_(0, torch.where(keep, idx.long(), n), vals, "amax",
                         include_self=True)
    return flat[:n].view(a.shape)


def last_writer(idx):
    """``(n,)`` bool: True where no later position writes the same index.

    A JAX ``.at[idx].set(vals)`` on the CPU applies its updates in order,
    so among duplicate indices the last one wins. Keeping only those
    writes gives the same result on any device, in any write order."""
    n = idx.shape[0]
    later = torch.ones(n, n, dtype=torch.bool, device=idx.device).triu_(1)
    return ~((idx[:, None] == idx[None, :]) & later).any(dim=1)


__all__ = ["set_drop", "amax_drop", "last_writer"]
