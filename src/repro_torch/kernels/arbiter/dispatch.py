"""Backend dispatch for the per-slot arbitration hot path (DESIGN.md §6).

  ``arbitrate(prio, seq, elig, backend=...)``   strict-priority-then-FIFO
      winner per row — the math of ``fabric.ring_drain_select``.
  ``topk(keys, K, backend=...)``                per-row top-K (values AND
      source columns) — the receiver's SRPT grant-set selection.
  ``fused_slot(down=..., up=..., topk=..., backend=...)``   all of a
      slot's stages in ONE kernel launch — the ``fused`` backend's entry
      point (DESIGN.md §11), called from ``sim._fused_precompute``.
  ``insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq,
      backend=...)``   chunks into per-row rings — ``fabric.ring_insert``;
      in place on the card on both kernel backends.

``backend="reference"`` runs the plain PyTorch versions (``ref.py``) on
whatever device the tensors are on; ``backend="cuda"`` runs the staged
hand-written kernels and ``backend="fused"`` the fused one (``kernel.py``,
``csrc/arbiter.cu``); the staged primitives still serve the fused
backend's call sites that are not fused. On CPU tensors the kernel
wrappers run the plain versions, so ``"fused"`` there means the hoisted
slot order with the plain fused version. All return the caller
convention of the JAX package: the top-K normalization (``repro``
``dispatch._topk_normalize``) is ``ref.topk_normalize``. The kernels need
neither the TPU's tile padding nor ``pad_min_cols``: they mask ragged
widths and handle K > M themselves.

The port's backend names are its own and it reads no environment
variable: ``$SIM_BACKEND`` belongs to the JAX package, which rejects
these names.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arbiter import kernel
from repro_torch.kernels.arbiter.ref import (fused_slot_ref,
                                             priority_arbiter_ref,
                                             ring_insert_ref, srpt_topk_ref,
                                             topk_normalize)

BACKENDS = ("reference", "cuda", "fused")
KERNEL_BACKENDS = ("cuda", "fused")


def resolve_backend(name: str | None, device: str | torch.device) -> str:
    """``None`` -> ``"cuda"`` on a CUDA device, ``"reference"`` on the CPU.
    ``"fused"`` runs on either device; unknown names raise."""
    device = torch.device(device)
    if name is None:
        return "cuda" if device.type == "cuda" else "reference"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{list(BACKENDS)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs the hand-written kernels and "
                         f"needs a CUDA device, got device={str(device)!r}")
    return name


def load_kernels(backend: str, device: str | torch.device) -> None:
    """Build (or load) the kernel library a backend launches on a card;
    nothing on the CPU, where every backend runs the plain versions."""
    if backend in KERNEL_BACKENDS and torch.device(device).type == "cuda":
        from repro_torch.kernels.arbiter.build import load_library
        load_library()


def arbitrate(prio, seq, elig, *, backend: str = "reference"):
    """Strict-priority, FIFO-within-level winner per row. Returns
    ``(best_prio (H,), best_idx (H,))``; rows with no eligible entry
    return ``(BIG, 0)``. Bit-identical across backends."""
    if backend in KERNEL_BACKENDS:
        return kernel.priority_arbiter(prio, seq, elig)
    return priority_arbiter_ref(prio, seq, elig)


def topk(keys, K: int, *, backend: str = "reference"):
    """Per-row top-K keys + source columns. Returns ``(vals (H, K), idx
    (H, K))``: descending keys clamped at 0, columns -1 where fewer than K
    positive keys exist, ties to the lowest column on both backends."""
    if backend in KERNEL_BACKENDS:
        return kernel.srpt_topk(keys, K)
    return srpt_topk_ref(keys, K)


def fused_slot(down=None, up=None, topk=None, *, backend: str = "fused"):
    """All present stages of one slot, mirroring the JAX package's
    ``dispatch.fused_slot``:

      down / up   ``(prio, seq, elig)`` — downlink / TOR-uplink drain
                  problems (either may be ``None``)
      topk        ``(keys, K)`` — the SRPT grant-set problem

    Operands carry a leading run axis B ``(B, rows, cols)``. ``"fused"``
    launches ``kernel.fused_slot`` at B = 1 and ``kernel.fused_slot_batch``
    above — one launch per slot either way; ``"reference"`` runs
    ``ref.fused_slot_ref``. Returns a dict with a key per present stage:
    ``"down"``/``"up"`` -> ``(best_prio (B, rows), best_idx)`` exactly as
    :func:`arbitrate`; ``"topk"`` -> normalized ``(vals (B, H2, K), idx)``
    exactly as :func:`topk`."""
    keys, K = topk if topk is not None else (None, 0)
    if backend == "reference":
        raw = fused_slot_ref(down, up, keys, K)
    elif backend == "fused":
        # the kernel reads dense rows, as the rings are on the card:
        # ring_insert updates them in place (the wrapper raises on
        # strided operands)
        B = (down or up or (keys,))[0].shape[0]
        if B == 1:
            drop = (lambda s: None if s is None
                    else tuple(t[0] for t in s))
            raw = kernel.fused_slot(drop(down), drop(up),
                                    None if keys is None else keys[0], K)
            raw = tuple(t[None] for t in raw)
        else:
            raw = kernel.fused_slot_batch(down, up, keys, K)
    else:
        raise ValueError(f"fused_slot: backend {backend!r} has no fused "
                         f"kernel; expected 'fused' or 'reference'")
    out, raw = {}, list(raw)
    for name, stage in (("down", down), ("up", up)):
        if stage is not None:
            out[name], raw = (raw[0], raw[1]), raw[2:]
    if keys is not None:
        out["topk"] = topk_normalize(raw[0], raw[1])
    return out


def insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq, *,
           backend: str = "reference"):
    """Chunks into per-row rings (``fabric.ring_insert``). On both kernel
    backends, rings on the card go through ``ring_insert_kernel``, which
    updates the four ring tensors in place and returns them; the
    ``reference`` backend and CPU tensors run the plain version, which
    returns new ones. Returns ``(msg_a, prio_a, seq_a, valid_a, dropped
    (B,))``, bit-identical across backends."""
    if backend in KERNEL_BACKENDS:
        return kernel.ring_insert(msg_a, prio_a, seq_a, valid_a, row, ok,
                                  msg, prio, seq)
    return ring_insert_ref(msg_a, prio_a, seq_a, valid_a, row, ok, msg,
                           prio, seq)


__all__ = ["BACKENDS", "resolve_backend", "load_kernels", "arbitrate", "topk",
           "fused_slot", "insert"]
