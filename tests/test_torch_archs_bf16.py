"""The six architectures that came with MLA and MoE in bf16, as the
models run, against the JAX package op by op on the CPU: prefill logits
and caches, and one decode step from JAX's caches carried across. The
setting, the parameters and the bounds are ``tests/test_torch_archs.py``'s
(its f32 half); this half runs JAX op by op, which takes most of its time,
so it is a file of its own.

Jamba's end-to-end bf16 bounds are wide (its random-weight stack carries
one flipped rounding far: with every router zeroed, so that no routing
can move, its logits still lie 0.37 from JAX's, ``python
tests/test_torch_archs.py --fixed``), so Jamba is also held layer by
layer: each of its 16 layers on JAX's own input to that layer, every
router zeroed (``_fix_routing``). Over 8 seeds (``PYTHONPATH=src python
tests/test_torch_archs_bf16.py``) the worst normwise errors are 5.3e-3 on
a layer's output, 8.4e-3 on its increment ``out - in`` and 6.1e-4 on its
caches, held to ``BF16_FRAC``'s 2e-2 for prefill logits and caches; and
at most 2.1% of the elements of a layer's output or of a cache differ
from JAX's bits, held to 8% (``BITS_DIFFER``): the port takes JAX's bf16
roundings op by op, and a rounding left out of the SSM's norm input or of
the experts' hidden layer makes 57% or 14% of a layer's elements differ
while staying inside the normwise bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_archs import (BF16_FRAC, JAMBA, NEW_ARCHS, _err, _jparams,
                              _np, _t, _tokens, decode_case, jreduced,
                              prefill_case, reduced_config)
from test_torch_archs import runs  # noqa: F401 (the module's fixture)
from repro.models import model as JM
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M

torch.set_num_threads(1)

BITS_DIFFER = 0.08


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_prefill_matches_jax_bf16(runs, arch):  # noqa: F811
    prefill_case(runs, arch, "bf16")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_decode_matches_jax_bf16(runs, arch):  # noqa: F811
    decode_case(runs, arch, "bf16")


def jamba_layer_errors(seed):
    """Per layer of bf16 Jamba with its routers zeroed, against JAX's
    ``layer_forward`` op by op, both fed JAX's output of the layer
    before: the normwise errors of the port's output, increment and
    caches, and the largest share of elements of the output or a cache
    whose bits differ from JAX's."""
    cfg, jcfg = reduced_config(JAMBA), jreduced(JAMBA)
    assert cfg.first_dense_layers == 0
    jp = _jparams(JAMBA, "bf16", seed, fixed_routing=True)
    tok = jnp.asarray(_tokens(100 + seed))
    pos = jnp.arange(tok.shape[1])
    out = []
    with jax.disable_jit():
        xj = JM._embed(jcfg, jp, tok, None)
        for l in range(cfg.num_layers):
            b, i = divmod(l, cfg.block_period)
            lj = jax.tree.map(lambda a: a[b], jp["blocks"][f"s{i}"])
            yj, cj, _ = JM.layer_forward(jcfg, lj, xj, l, positions=pos,
                                         mode="prefill")
            xt = torch.from_numpy(_np(xj)).to(torch.bfloat16)
            yt, ct, _ = M.layer_forward(
                cfg, params_from_jax(jax.tree.map(np.asarray, lj), "cpu"),
                xt, l)
            assert sorted(ct) == sorted(cj) != []
            pairs = [(_t(yt), _np(yj))] + [(_t(ct[k]), _np(cj[k]))
                                            for k in ct]
            out.append((_err(_t(yt), _np(yj)),
                        _err(_t(yt) - _t(xt), _np(yj) - _np(xj)),
                        max(_err(a, b) for a, b in pairs[1:]),
                        max(float((a != b).mean()) for a, b in pairs)))
            xj = yj
    return out


def test_jamba_layers_match_jax_bf16():
    """Each bf16 Jamba layer (SSM or attention, MoE or MLP) on JAX's own
    input, routing fixed: output, increment and caches within the other
    archs' bf16 bound (see the docstring)."""
    frac = BF16_FRAC[""][0]
    errs = jamba_layer_errors(0)
    assert len(errs) == reduced_config(JAMBA).num_layers
    for l, e in enumerate(errs):
        assert max(e[:3]) <= frac and e[3] <= BITS_DIFFER, (l, e)


if __name__ == "__main__":
    # the measurement behind the layer-by-layer bound
    torch.set_num_threads(4)
    worst = [0.0] * 4
    for s in range(8):
        for e in jamba_layer_errors(s):
            worst = [max(w, x) for w, x in zip(worst, e)]
    print("Jamba bf16 layer by layer, 8 seeds: output %.2e increment %.2e "
          "caches %.2e, share of elements whose bits differ %.4f"
          % tuple(worst))
