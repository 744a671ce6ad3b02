"""The SSD entry point the model calls: pads the sequence to a multiple of
the chunk and runs the chunk-scan kernel (``kernel.ssd_scan``), as the
JAX package's ``kernels/ssd/ops.py:ssd`` runs ``ssd_pallas``.

A padded step has ``dt = 0``: it neither decays the state nor adds to
it, so the final state is that of the unpadded sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.kernel import ssd_scan


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N). Returns
    (y (B,S,H,P) f32, final_state (B,H,P,N) f32). On a CUDA tensor this
    launches the kernel (x, Bm, Cm bf16; dt f32); on the CPU it runs the
    kernel's plain version."""
    B, S, H, P = x.shape
    c = min(chunk, S) if S % min(chunk, S) == 0 else chunk
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, fs = ssd_scan(x, dt, A.to(torch.float32), Bm, Cm, chunk=c)
    return y[:, :S], fs
