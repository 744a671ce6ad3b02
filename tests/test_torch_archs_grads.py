"""The gradients of DeepSeek-V2-Lite (MLA + MoE) and Jamba (SSM +
attention + MoE) against ``jax.value_and_grad`` (compiled) on the CPU, at
``reduced_config``, with ``tests/test_torch_train.py``'s parameters,
batches and bounds:

- ``f32``: each leaf normwise within 1e-4, or — where the stack is
  ill-conditioned — within 4x the distance JAX's own gradient moves under
  an fp32-rounding-sized perturbation of the parameters (below);
- ``bf16``: each leaf (the fp32 router's in fp32) at most 4x as far
  (relative RMS) from JAX's fp32 gradient as JAX's own bf16 gradient is,
  plus 1e-3 (measured ratios at most 1.34 for DeepSeek and 2.74 for
  Jamba over 8 seeds: ``python tests/test_torch_archs_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as jreduced
from repro.models import model as JM
from repro_torch.configs.reduced import reduced_config
from repro_torch.tree import flatten
from test_torch_archs_train import GRAD_ARCHS, _f32_loss_tol
from test_torch_train import (BF16_TOL, F32_TOL, _batch, _params,
                              _port_grads, _rel)

torch.set_num_threads(1)



_VG = {}


def _jax_grads(arch, jp, batch):
    """``test_torch_train._jax_grads`` with one compiled function per
    arch, reused across calls."""
    if arch not in _VG:
        cfg = jreduced(arch)
        _VG[arch] = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True))
    (loss, aux), g = _VG[arch](jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    return float(loss), aux, [np.asarray(x.astype(jnp.float32))
                              for x in jax.tree.leaves(g)]


@pytest.fixture(scope="module")
def jax_grads():
    """(arch, dtype) -> parameters of both packages, the batch and JAX's
    (loss, parts, grads), computed once per module."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jp, tp = _params(arch, dtype, 5)
            batch = _batch(reduced_config(arch), 5)
            cache[arch, dtype] = (jp, tp, batch,
                                  _jax_grads(arch, jp, batch))
        return cache[arch, dtype]
    return get


def _normwise(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_f32(jax_grads, arch):
    """Each f32 gradient leaf within 1e-4 normwise of JAX's, or within 4x
    the distance JAX's own gradient moves when every parameter is
    perturbed by fp32 rounding (a relative 1e-7, from a numpy seed):
    Jamba's random-weight stack of SSM and MoE layers is ill-conditioned
    in its first blocks (such a perturbation moves JAX's gradient of
    ``blocks/s0/ffn/wd`` by 7.6% at one seed), so no port can be held
    closer than JAX is to itself there. DeepSeek's leaves all meet 1e-4
    (measured 2.7e-6)."""
    jp, tp, batch, (jl, jaux, jg) = jax_grads(arch, "f32")
    tl, taux, tg = _port_grads(arch, tp, batch)
    assert abs(tl - jl) <= _f32_loss_tol(arch) * abs(jl)
    assert abs(float(taux["aux"]) - float(jaux["aux"])) \
        <= F32_TOL["loss"] * abs(float(jaux["aux"]))
    rng = np.random.default_rng(7)
    jp2 = jax.tree.map(lambda a: a * (1 + 1e-7 * rng.standard_normal(
        a.shape)).astype(np.float32), jp)
    _, _, jg2 = _jax_grads(arch, jp2, batch)
    assert len(flatten(tg)) == len(jg)
    for a, b, b2 in zip(flatten(tg), jg, jg2):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        err = _normwise(a.numpy(), b)
        assert err <= F32_TOL["grad"] or err <= 4 * _normwise(b2, b), err
        if arch == "deepseek-v2-lite-16b":
            assert err <= F32_TOL["grad"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_bf16(jax_grads, arch):
    """Each bf16 gradient leaf (the fp32 router's in fp32) is about as far
    from JAX's fp32 gradient as JAX's bf16 gradient is."""
    _, _, batch, (_, _, j32) = jax_grads(arch, "f32")
    _, tp16, batch16, (_, _, j16) = jax_grads(arch, "bf16")
    assert all(np.array_equal(batch[k], batch16[k]) for k in batch)
    _, _, tg = _port_grads(arch, tp16, batch)
    dtypes = set()
    for a, b16, b32 in zip(flatten(tg), j16, j32):
        dtypes.add(a.dtype)
        assert _rel(a.float().numpy(), b32) <= BF16_TOL["ratio"] \
            * _rel(b16, b32) + BF16_TOL["floor"]
    assert dtypes == {torch.bfloat16, torch.float32}
