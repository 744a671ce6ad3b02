"""Python entry points of the hand-written arbitration kernels.

``priority_arbiter``, ``srpt_topk``, ``fused_slot``,
``fused_slot_batch`` and ``ring_insert`` take the tensors the simulator
holds and run ``csrc/arbiter.cu`` (built by :mod:`.build`) on PyTorch's
current stream. ``ring_insert`` alone writes into its arguments: it
updates the rings in place.
A tensor on the CPU goes to the plain version in :mod:`.ref` instead; a
CUDA tensor launches the kernel or raises — a failed build or launch
never falls back.

Which top-K routine a launch runs (:func:`topk_cap`): for K up to 8 the
one-pass routine, instantiated for that cap; for a larger K the rounds
routine, which re-reads the row once per rank. Both compute the same
function. The staged arbiter runs at one layout, ``ARB_LAYOUT`` threads
a row and rows a block.

Each wrapper counts its kernel launches in a plain integer attribute
(``priority_arbiter.launches`` and so on), raised only where the kernel
is launched, so a run can show that it went through the kernels. The
wrappers with a top-K stage also count the launches that took the rounds
routine, in ``srpt_topk.launches_rounds``, ``fused_slot.launches_rounds``
and ``fused_slot_batch.launches_rounds``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.arbiter.build import load_library
from repro_torch.kernels.arbiter.ref import (BIG, NEG, fused_slot_ref,
                                             priority_arbiter_ref,
                                             ring_insert_ref, srpt_topk_ref,
                                             topk_normalize)


TOPK_CAPS = (8,)    # K caps of the one-pass top-K instances (csrc)
# (threads a row, rows a block) of the staged arbiter's instances (csrc)
ARB_LAYOUTS = ((256, 1), (128, 1), (64, 2), (32, 8))
# the one the wrapper launches, at any row count: of ARB_LAYOUTS the
# fastest or within 2% of it at all four shapes chip_smoke.py times --
# B = 1's 144 rows of 1024 and 512 columns (latency) and the B = 12
# staged sweep's 1728 rows (bytes); PERF.md
ARB_LAYOUT = (64, 2)


def topk_cap(K: int) -> int:
    """The wrappers' rule: the one-pass instance for K (the smallest cap
    in ``TOPK_CAPS`` that is at least K), or 0, the rounds routine, for a
    K above the largest cap."""
    return next((c for c in TOPK_CAPS if K <= c), 0)


def _check(name, tensors, dtypes, ndim=2, device=None):
    dev = device or tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {dev}")
    shape = tensors[0].shape
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dim() != ndim or t.shape != shape:
            raise ValueError(f"{name}: expected {ndim}-D tensors of one "
                             f"shape, got {tuple(shape)} and "
                             f"{tuple(t.shape)}")
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
        best_prio.data_ptr(), best_idx.data_ptr(), H, cap, *ARB_LAYOUT,
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
    cap = topk_cap(K)
    lib = load_library()
    rc = lib.arbiter_topk_launch(
        keys.data_ptr(), vals.data_ptr(), idx.data_ptr(), H, M, K, cap,
        torch.cuda.current_stream(keys.device).cuda_stream)
    _raise_on(rc, "srpt_topk", lib)
    srpt_topk.launches += 1
    srpt_topk.launches_rounds += cap == 0
    return topk_normalize(vals, idx)


def _fused(wrapper, down, up, keys, K, batched):
    """The body of both fused wrappers: the plain version for CPU
    tensors; otherwise check the present stages, allocate their outputs,
    launch ``fused_slot_kernel`` once and count it on ``wrapper``.
    ``batched`` operands carry a leading run axis B; otherwise B = 1 and
    the outputs have none."""
    name = wrapper.__name__
    stages = [s for s in (down, up) if s is not None]
    if keys is not None:
        stages.append((keys,))
    if not stages:
        raise ValueError(f"{name}: no stage given")
    dev = stages[0][0].device
    if dev.type == "cpu":
        return fused_slot_ref(down, up, keys, K)
    if keys is not None and K < 1:
        raise ValueError(f"{name}: K must be >= 1, got {K}")
    nd = 3 if batched else 2
    lead = tuple(stages[0][0].shape[:1]) if batched else ()
    for s in stages:
        if s[0].dim() != nd or tuple(s[0].shape[:nd - 2]) != lead:
            raise ValueError(f"{name}: expected {nd}-D operands"
                             + (" with one leading run axis" if batched
                                else "") + f", got {tuple(s[0].shape)}")
    args, out = [], []
    for s in (down, up):
        if s is None:
            args += [None] * 5 + [0, 0]
            continue
        _check(name, s, (torch.int32, torch.int32, torch.bool), nd, dev)
        rows, cols = s[0].shape[-2:]
        bp = torch.empty(lead + (rows,), dtype=torch.int32, device=dev)
        bi = torch.empty_like(bp)
        args += [t.data_ptr() for t in (*s, bp, bi)] + [rows, cols]
        out += [bp, bi]
    if keys is None:
        args += [None] * 3 + [0, 0, 0]
    else:
        _check(name, (keys,), (torch.int32,), nd, dev)
        rows, M = keys.shape[-2:]
        vals = torch.empty(lead + (rows, K), dtype=torch.int32, device=dev)
        idx = torch.empty_like(vals)
        args += [keys.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, M,
                 K]
        out += [vals, idx]
    cap = topk_cap(K)
    lib = load_library()
    rc = lib.arbiter_fused_launch(
        *args, cap, lead[0] if batched else 1, 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, name, lib)
    wrapper.launches += 1
    wrapper.launches_rounds += keys is not None and cap == 0
    return tuple(out)


def fused_slot(down=None, up=None, keys=None, K: int = 0):
    """One slot's arbitration stages in one launch (B = 1). ``down``/``up``
    are ``(prio (R, cap), seq, elig)`` drain problems as for
    :func:`priority_arbiter`, ``keys`` an ``(H2, M)`` int32 top-K problem
    with ``K >= 1``; each is optional. Returns the raw outputs in stage
    order, ``[d_prio, d_idx][, u_prio, u_idx][, vals, idx]``: the
    arbiter's ``(BIG, 0)`` for empty rows, the top-K unnormalized
    (``(NEG, -1)`` past a row's width; callers normalize)."""
    return _fused(fused_slot, down, up, keys, K, batched=False)


def fused_slot_batch(down=None, up=None, keys=None, K: int = 0):
    """:func:`fused_slot` for B runs in one launch: every operand carries a
    leading run axis B, and so does every output."""
    return _fused(fused_slot_batch, down, up, keys, K, batched=True)


def ring_insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq):
    """:func:`ref.ring_insert_ref` in one launch, in place: the rings
    ``msg_a``/``prio_a``/``seq_a`` (int32) and ``valid_a`` (bool), ``(B,
    R, cap)`` and contiguous, take the inserted chunks where they are,
    and the same four tensors come back. The items ``row``/``msg``/
    ``prio``/``seq`` (int32) and ``ok`` (bool) are ``(B, n)`` at any
    strides (``seq`` is often one slot number expanded); nothing is
    copied. Returns ``(msg_a, prio_a, seq_a, valid_a, dropped (B,)
    int32)``. CPU tensors take the plain version, which returns new
    rings."""
    if valid_a.device.type == "cpu":
        return ring_insert_ref(msg_a, prio_a, seq_a, valid_a, row, ok, msg,
                               prio, seq)
    rings = (msg_a, prio_a, seq_a, valid_a)
    _check("ring_insert", rings, (torch.int32,) * 3 + (torch.bool,), 3)
    B, R, cap = valid_a.shape
    n = row.shape[-1]
    items = (row, ok, msg, prio, seq)
    for t, dt in zip(items, (torch.int32, torch.bool) + (torch.int32,) * 3):
        if t.dtype != dt:
            raise TypeError(f"ring_insert: expected {dt} items, got "
                            f"{t.dtype}")
        if t.device != valid_a.device:
            raise ValueError(f"ring_insert: tensors on {valid_a.device} and "
                             f"{t.device}")
        if tuple(t.shape) != (B, n):
            raise ValueError(f"ring_insert: expected ({B}, n) items, got "
                             f"{tuple(t.shape)} and {tuple(row.shape)}")
    dropped = torch.empty(B, dtype=torch.int32, device=valid_a.device)
    if B:
        strides = (ctypes.c_longlong * 10)(*(s for t in items
                                             for s in t.stride()))
        lib = load_library()
        rc = lib.arbiter_ring_insert_launch(
            *(t.data_ptr() for t in rings), B, R, cap,
            *(t.data_ptr() for t in items), strides, n, dropped.data_ptr(),
            torch.cuda.current_stream(valid_a.device).cuda_stream)
        _raise_on(rc, "ring_insert", lib)
        ring_insert.launches += 1
    return (*rings, dropped)


WRAPPERS = (priority_arbiter, srpt_topk, fused_slot, fused_slot_batch,
            ring_insert)
TOPK_WRAPPERS = (srpt_topk, fused_slot, fused_slot_batch)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in TOPK_WRAPPERS:
        fn.launches_rounds = 0


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["BIG", "NEG", "TOPK_CAPS", "topk_cap", "ARB_LAYOUTS",
           "ARB_LAYOUT", "priority_arbiter",
           "srpt_topk", "fused_slot", "fused_slot_batch", "ring_insert",
           "reset_launch_counts", "launch_counts"]
