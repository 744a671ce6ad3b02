"""Backend dispatch for the per-slot arbitration hot path (DESIGN.md §6).

  ``arbitrate(prio, seq, elig, backend=...)``   strict-priority-then-FIFO
      winner per row — the math of ``fabric.ring_drain_select``.
  ``topk(keys, K, backend=...)``                per-row top-K (values AND
      source columns) — the receiver's SRPT grant-set selection.

``backend="reference"`` runs the plain PyTorch versions (``ref.py``) on
whatever device the tensors are on; ``backend="cuda"`` runs the
hand-written kernels (``kernel.py``, ``csrc/arbiter.cu``). Both return
the caller convention of the JAX package: the top-K normalization
(``repro`` ``dispatch._topk_normalize``) is ``ref.topk_normalize``,
shared by the plain version and the kernel's wrapper. The kernels need
neither the TPU's tile padding nor ``pad_min_cols``: they mask ragged
widths and handle K > M themselves.

The port's backend names are its own and it reads no environment
variable: ``$SIM_BACKEND`` belongs to the JAX package, which rejects
these names.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arbiter import kernel
from repro_torch.kernels.arbiter.ref import priority_arbiter_ref, srpt_topk_ref

BACKENDS = ("reference", "cuda")


def resolve_backend(name: str | None, device: str | torch.device) -> str:
    """``None`` -> ``"cuda"`` on a CUDA device, ``"reference"`` on the CPU.
    The fused backend is not ported yet; unknown names raise."""
    device = torch.device(device)
    if name is None:
        return "cuda" if device.type == "cuda" else "reference"
    if name in ("pallas_fused", "fused"):
        raise NotImplementedError(
            f"backend {name!r}: the fused per-slot kernel is not ported to "
            f"repro_torch yet (ROADMAP B3)")
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{list(BACKENDS)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' runs the hand-written kernels and "
                         f"needs a CUDA device, got device={str(device)!r}")
    return name


def arbitrate(prio, seq, elig, *, backend: str = "reference"):
    """Strict-priority, FIFO-within-level winner per row. Returns
    ``(best_prio (H,), best_idx (H,))``; rows with no eligible entry
    return ``(BIG, 0)``. Bit-identical across backends."""
    if backend == "cuda":
        return kernel.priority_arbiter(prio, seq, elig)
    return priority_arbiter_ref(prio, seq, elig)


def topk(keys, K: int, *, backend: str = "reference"):
    """Per-row top-K keys + source columns. Returns ``(vals (H, K), idx
    (H, K))``: descending keys clamped at 0, columns -1 where fewer than K
    positive keys exist, ties to the lowest column on both backends."""
    if backend == "cuda":
        return kernel.srpt_topk(keys, K)
    return srpt_topk_ref(keys, K)


__all__ = ["BACKENDS", "resolve_backend", "arbitrate", "topk"]
