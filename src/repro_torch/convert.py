"""Carry simulator state across from the JAX package.

``from_jax(S_np, state_np, device)`` turns the numpy form of the JAX
package's ``prepare`` statics and of a scan state (``SimResult.static``
and ``SimResult.state`` of ``repro.core.simulate(..., return_state=True)``)
into the port's tensors, with the same keys, dtypes and shapes. The port
can then step on from the JAX package's mid-run state
(``repro_torch.core.sim.run_slots``), which is how the tests check the
two simulators slot for slot. Only numpy crosses: this module imports
nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: arrays from a JAX device buffer are read-only
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(S_np: dict, state_np: dict, device) -> tuple[dict, dict]:
    """``(S, state)`` as tensors on ``device``; int32, bool and float32
    arrays keep their dtypes and shapes, 0-d counters stay 0-d."""
    return ({k: _tensor(v, device) for k, v in S_np.items()},
            {k: _tensor(v, device) for k, v in state_np.items()})


__all__ = ["from_jax"]
