"""Python entry points of the hand-written arbitration kernels.

``priority_arbiter`` and ``srpt_topk`` take the tensors the simulator
holds and run ``csrc/arbiter.cu`` (built by :mod:`.build`) on PyTorch's
current stream. A tensor on the CPU goes to the plain version in
:mod:`.ref` instead; a CUDA tensor launches the kernel or raises — a
failed build or launch never falls back.

Each wrapper counts its kernel launches in a plain integer attribute
(``priority_arbiter.launches``, ``srpt_topk.launches``), raised only where
the kernel is launched, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arbiter.build import load_library
from repro_torch.kernels.arbiter.ref import (BIG, NEG, priority_arbiter_ref,
                                             srpt_topk_ref, topk_normalize)


def _check(name, tensors, dtypes):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {dev}")
    shape = tensors[0].shape
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"{name}: expected 2-D tensors of one shape, "
                             f"got {tuple(shape)} and {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_on(rc: int, name: str, lib) -> None:
    if rc != 0:
        msg = lib.arbiter_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def priority_arbiter(prio, seq, elig):
    """Strict-priority, FIFO-within-level winner per row.

    ``prio``/``seq`` ``(H, cap)`` int32 with values in ``[0, BIG]``,
    ``elig`` ``(H, cap)`` bool. Returns ``(best_prio (H,), best_idx (H,))``
    int32; a row with no eligible entry gives ``(BIG, 0)``."""
    if prio.device.type == "cpu":
        return priority_arbiter_ref(prio, seq, elig)
    _check("priority_arbiter", (prio, seq, elig),
           (torch.int32, torch.int32, torch.bool))
    H, cap = prio.shape
    best_prio = torch.empty(H, dtype=torch.int32, device=prio.device)
    best_idx = torch.empty(H, dtype=torch.int32, device=prio.device)
    lib = load_library()
    rc = lib.arbiter_priority_launch(
        prio.data_ptr(), seq.data_ptr(), elig.data_ptr(),
        best_prio.data_ptr(), best_idx.data_ptr(), H, cap,
        torch.cuda.current_stream(prio.device).cuda_stream)
    _raise_on(rc, "priority_arbiter", lib)
    priority_arbiter.launches += 1
    return best_prio, best_idx


def srpt_topk(keys, K: int):
    """Per row, the K largest keys in descending order and their columns,
    ties to the lowest column. ``keys`` ``(H, M)`` int32, any K >= 1
    (K > M included). Returns ``(vals (H, K), idx (H, K))`` int32: keys
    clamped at 0, columns -1 where fewer than K positive keys exist."""
    if K < 1:
        raise ValueError(f"srpt_topk: K must be >= 1, got {K}")
    if keys.device.type == "cpu":
        return srpt_topk_ref(keys, K)
    _check("srpt_topk", (keys,), (torch.int32,))
    H, M = keys.shape
    vals = torch.empty((H, K), dtype=torch.int32, device=keys.device)
    idx = torch.empty((H, K), dtype=torch.int32, device=keys.device)
    lib = load_library()
    rc = lib.arbiter_topk_launch(
        keys.data_ptr(), vals.data_ptr(), idx.data_ptr(), H, M, K,
        torch.cuda.current_stream(keys.device).cuda_stream)
    _raise_on(rc, "srpt_topk", lib)
    srpt_topk.launches += 1
    return topk_normalize(vals, idx)


priority_arbiter.launches = 0
srpt_topk.launches = 0

WRAPPERS = (priority_arbiter, srpt_topk)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["BIG", "NEG", "priority_arbiter", "srpt_topk",
           "reset_launch_counts", "launch_counts"]
