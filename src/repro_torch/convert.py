"""Carry simulator state and model parameters across from the JAX package.

``from_jax(S_np, state_np, device)`` turns the numpy form of the JAX
package's ``prepare`` statics and of a scan state (``SimResult.static``
and ``SimResult.state`` of ``repro.core.simulate(..., return_state=True)``)
into the port's tensors, with the same keys and dtypes. One run or a list
of runs of one shape may be given; either way the result carries the
leading run axis the port's step carries, so the port can step on from
the JAX package's mid-run state (``repro_torch.core.sim.run_slots``),
which is how the tests check the two simulators slot for slot.

``params_from_jax(params_np, device)`` does the same for a model's
parameter tree (``repro.models.params.init_params``'s output as numpy
arrays): the port's tree with the same keys, shapes and dtypes, so both
packages run one set of weights. ``opt_state_from_jax(opt_np, device)``
carries an AdamW state (``repro.training.optimizer.init_opt_state``'s
tree, or one a JAX step returned) across the same way, so that both
packages can take a step from one state. Only numpy crosses: this module
imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _stack(runs: list[dict], device) -> dict:
    # np.stack copies: arrays from a JAX device buffer are read-only
    return {k: torch.from_numpy(np.stack([np.asarray(r[k]) for r in runs]))
            .to(device) for k in runs[0]}


def from_jax(S_np: dict | list[dict], state_np: dict | list[dict],
             device) -> tuple[dict, dict]:
    """``(S, state)`` as tensors on ``device`` with a leading run axis
    (length 1 for a single run); int32, bool and float32 arrays keep
    their dtypes, and run b's slice has the JAX array's shape."""
    if isinstance(S_np, dict):
        S_np = [S_np]
    if isinstance(state_np, dict):
        state_np = [state_np]
    return _stack(list(S_np), device), _stack(list(state_np), device)


def _tensor(a, device) -> torch.Tensor:
    # copy: arrays from a JAX device buffer are read-only. A JAX bf16
    # array's numpy dtype is ml_dtypes.bfloat16, which torch.from_numpy
    # refuses, so bf16 crosses as its 16-bit pattern.
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params_np: dict, device) -> dict:
    """The JAX package's parameter tree (nested dicts of numpy arrays,
    bf16 as ``ml_dtypes.bfloat16``) as the port's tree of tensors on
    ``device``: same keys, shapes and dtypes, bit for bit."""
    if isinstance(params_np, dict):
        return {k: params_from_jax(v, device) for k, v in params_np.items()}
    return _tensor(params_np, device)


def opt_state_from_jax(opt_np: dict, device) -> dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` (numpy) as the
    port's: m and v trees like ``params_from_jax``'s, bit for bit in
    their dtype, and ``step`` an int32 0-d tensor."""
    return {"m": params_from_jax(opt_np["m"], device),
            "v": params_from_jax(opt_np["v"], device),
            "step": _tensor(np.asarray(opt_np["step"], np.int32), device)}


__all__ = ["from_jax", "opt_state_from_jax", "params_from_jax"]
