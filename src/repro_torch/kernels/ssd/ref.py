"""Plain PyTorch version of the SSD kernel: the sequential per-token
recurrence in fp32, the same function as the JAX package's
``kernels/ssd/ref.py:ssd_ref``.

    state_t = exp(dt_t * A) * state_{t-1} + dt_t * B_t (x) x_t
    y_t     = C_t . state_t
"""
from __future__ import annotations

import torch

F32 = torch.float32


def ssd_ref(x, dt, A, Bm, Cm):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.to(F32), dt.to(F32), A.to(F32)
    Bf, Cf = Bm.to(F32), Cm.to(F32)
    state = torch.zeros((B, H, P, N), dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                        # (B,H)
        upd = torch.einsum("bn,bhp->bhpn", Bf[:, t],
                           xf[:, t] * dtf[:, t, :, None])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else torch.zeros((B, 0, H, P), dtype=F32,
                                                  device=x.device)
    return y, state
