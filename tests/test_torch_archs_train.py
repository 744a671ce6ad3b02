"""The training loss of the six architectures that came with MLA and MoE
(``loss_fn``: loss, nll, the MoE aux loss and the z-loss) against the JAX
package on the CPU, at ``reduced_config``; their gradients are
``tests/test_torch_archs_grads.py``'s.

The parameters and batches are ``tests/test_torch_train.py``'s (its
helpers draw JAX's ``init_params`` tree and carry it across):

- ``f32``, against compiled JAX: loss, nll, z-loss and the aux loss — a
  function of the routing and the router's probabilities only — within
  ``test_torch_train.py``'s rtol 1e-6 (Jamba's loss parts 1e-5, below);
- ``bf16``, against JAX op by op, which rounds where the port does:
  within BF16_LOSS (below).

Without the aux term the port's MoE loss would silently differ from
JAX's by ``aux_weight * aux``; these tests pin it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.models import model as JM
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import model as M
from repro_torch.tree import flatten
from test_torch_train import (BF16_TOL, F32_TOL, _batch, _params,
                              _port_grads, _rel)

torch.set_num_threads(1)

ARCHS = ["stablelm-12b", "llama3-405b", "qwen2-7b", "mixtral-8x7b",
         "deepseek-v2-lite-16b", "jamba-1.5-large-398b"]
GRAD_ARCHS = ["deepseek-v2-lite-16b", "jamba-1.5-large-398b"]
MOE = ("mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")
# Jamba's f32 loss: its 16 layers carry fp32 rounding to 2.9e-6 of the
# loss parts (measured over 8 seeds; the others 2.2e-7), so 1e-5 there
# and test_torch_train.py's 1e-6 elsewhere
JAMBA_F32_LOSS = 1e-5
# bf16 against JAX op by op (compiled JAX skips bf16 roundings and lies up
# to 2.5% from it on Jamba): rtol of loss, nll, zloss and aux, ~4x the
# largest measured over 8 seeds (in the comments)
BF16_LOSS = {"stablelm-12b": 5e-4,            # 7.5e-5
             "llama3-405b": 5e-4,             # 9.6e-6
             "qwen2-7b": 5e-4,                # 4.9e-5
             "mixtral-8x7b": 5e-4,            # 5.4e-5
             "deepseek-v2-lite-16b": 7e-4,    # 1.7e-4
             "jamba-1.5-large-398b": 2e-2}    # 4.2e-3


def _f32_loss_tol(arch):
    return JAMBA_F32_LOSS if arch.startswith("jamba") else F32_TOL["loss"]


def _jax_loss(arch, jp, batch, eager=False):
    """JAX's ``loss_fn``: compiled, or op by op (``eager``)."""
    cfg = jreduced(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if eager:
        with jax.disable_jit():
            loss, parts = JM.loss_fn(cfg, jp, jb)
    else:
        loss, parts = jax.jit(lambda p, b: JM.loss_fn(cfg, p, b))(jp, jb)
    return float(loss), {k: float(v) for k, v in parts.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_parts_match_jax(arch, dtype):
    """loss, nll, aux and zloss of ``loss_fn`` (remat on, as trained):
    against compiled JAX in f32, against JAX op by op in bf16."""
    jp, tp = _params(arch, dtype, 6)
    batch = _batch(reduced_config(arch), 6)
    jl, jparts = _jax_loss(arch, jp, batch, eager=dtype == "bf16")
    with torch.no_grad():
        tl, tparts = M.loss_fn(reduced_config(arch), tp,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    rtol = _f32_loss_tol(arch) if dtype == "f32" else BF16_LOSS[arch]
    assert abs(float(tl) - jl) <= rtol * abs(jl)
    for k in ("nll", "zloss"):
        assert abs(float(tparts[k]) - jparts[k]) <= rtol * abs(jparts[k])
    if arch in MOE:
        assert jparts["aux"] > 0.5
        assert abs(float(tparts["aux"]) - jparts["aux"]) \
            <= rtol * jparts["aux"]
    else:
        assert float(tparts["aux"]) == jparts["aux"] == 0.0


# ------------------------------------------------ how the bounds were set --

def _measure(seeds=range(8)):
    """Over ``seeds`` (each its own parameters and batch), the largest
    relative distance of the port's loss parts (loss, nll, zloss, aux) to
    compiled JAX's in f32 and to JAX's op by op in bf16; for DeepSeek and
    Jamba also each f32 gradient leaf's normwise distance, and the bf16
    gradient rule's ratio (rel RMS to JAX's fp32 gradient, less the 1e-3
    floor, over JAX's own bf16 gradient's)."""
    worst = {}
    for arch in ARCHS:
        cfg, jcfg = reduced_config(arch), jreduced(arch)
        grad = arch in GRAD_ARCHS
        vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b),
                                        has_aux=True))
        w = worst.setdefault(arch, dict(f32=0.0, bf16=0.0, grad=0.0,
                                        ratio=0.0))
        for seed in seeds:
            batch = _batch(cfg, seed)
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            grads = {}
            for dtype in ("f32", "bf16"):
                jp, tp = _params(arch, dtype, seed)
                jl, jparts = _jax_loss(arch, jp, batch, eager=dtype == "bf16")
                with torch.no_grad():
                    tl, tparts = M.loss_fn(cfg, tp, tb)
                for k, want in (("loss", jl), *jparts.items()):
                    got = float(tl) if k == "loss" else float(tparts[k])
                    if want:
                        w[dtype] = max(w[dtype], abs(got - want) / abs(want))
                if grad:
                    _, jg = vg(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
                    grads[dtype] = ([np.asarray(x.astype(jnp.float32))
                                     for x in jax.tree.leaves(jg)],
                                    flatten(_port_grads(arch, tp, batch)[2]))
            if grad:
                (j32, t32), (j16, t16) = grads["f32"], grads["bf16"]
                for a, b in zip(t32, j32):
                    w["grad"] = max(w["grad"], float(
                        np.abs(a.numpy() - b).max() / np.abs(b).max()))
                for a, b16, b32 in zip(t16, j16, j32):
                    w["ratio"] = max(w["ratio"], (
                        _rel(a.float().numpy(), b32) - BF16_TOL["floor"])
                        / max(_rel(b16, b32), 1e-30))
        print(arch, {k: f"{v:.2e}" for k, v in w.items()}, flush=True)
    return worst


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_archs_train.py: the
    # measurements behind the bounds here and in test_torch_archs_grads.py
    torch.set_num_threads(4)
    _measure()
