"""The attention entry point the model calls: pads both sequence axes to
block multiples and runs the flash-attention kernel
(``kernel.flash_attention``) with ``kv_len`` at the unpadded length, as
the JAX package's ``kernels/attention/ops.py:attention`` runs its Pallas
kernel.

The CUDA kernel masks ragged tails itself and does not need the padding;
it is kept because it is part of the function: a row with no valid key
averages v over every key the kernel is given, padded zeros included,
as JAX's does.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.attention.kernel import flash_attention


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              block_q: int = 128, block_kv: int = 128):
    """q: (B, Sq, H, d); k/v: (B, Skv, KV, d/dv). Returns (B, Sq, H, dv)
    in q's dtype. On a CUDA tensor this launches the kernel (on
    contiguous copies of strided operands); on the CPU it runs the
    kernel's plain version."""
    Sq, Skv = q.shape[1], k.shape[1]
    bq = min(block_q, max(8, Sq))
    bk = min(block_kv, max(8, Skv))
    pq, pk = (-Sq) % bq, (-Skv) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=causal, window=window, kv_len=Skv)
    return out[:, :Sq]
