"""The port's sharding plan (``repro_torch.distrib.sharding``,
``models.params.param_specs``) against the JAX package's, exactly: the
parameter specs of every architecture on both production meshes, and
the rules, batch axes, activation specs (with and without microbatches),
cache specs and divisibility notes of every arch x shape x mesh cell.

JAX's functions read only ``mesh.axis_names`` and ``mesh.devices.shape``
and the port's only ``mesh.mesh_dim_names`` and ``mesh.shape``, so one
stand-in with those fields serves both packages without 512 devices.
Also: the port's ``PartitionSpec`` normalizes as JAX's, ``placements``
maps a spec onto a mesh as DTensor reads it, and the ``cst`` hook leaves
everything alone without a spec.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES as JSHAPES
from repro.distrib import sharding as JSH
from repro.models import model as JM
from repro.models import params as JPR
from repro.training.step import choose_grad_accum as jax_choose_grad_accum
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distrib import sharding as SH
from repro_torch.models import model as M
from repro_torch.models import params as PR
from repro_torch.training.step import choose_grad_accum

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class StandInMesh:
    """The fields both packages' sharding functions read."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = np.empty(shape, dtype=np.int8)
        self.shape = shape


def _mesh(name):
    return StandInMesh(*MESHES[name])


def _same(port, jax_tree, path=""):
    """Equal trees: the same keys, and each port spec equal to JAX's
    entry by entry (JAX's ``PartitionSpec`` is no tuple)."""
    if isinstance(jax_tree, dict):
        assert isinstance(port, dict) and set(port) == set(jax_tree), path
        for k in jax_tree:
            _same(port[k], jax_tree[k], f"{path}/{k}")
        return
    if isinstance(jax_tree, JP):
        assert isinstance(port, SH.PartitionSpec), (path, port)
        assert tuple(port) == tuple(jax_tree), (path, port, jax_tree)
        return
    assert port == jax_tree, (path, port, jax_tree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_jax(arch, mesh):
    m = _mesh(mesh)
    cfg, jcfg = get_config(arch), jax_config(arch)
    _same(SH.model_param_specs(cfg, m), JSH.model_param_specs(jcfg, m))
    sizes = SH.mesh_sizes(m)
    assert sizes == JSH.mesh_sizes(m)
    for force in (True, False):
        rules = SH.sharding_rules(cfg, sizes, force_fsdp=force)
        assert rules == JSH.sharding_rules(jcfg, sizes, force_fsdp=force)
        _same(PR.param_specs(M.model_defs(cfg), rules, sizes),
              JPR.param_specs(JM.model_defs(jcfg), rules, sizes))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_plan_matches_jax(arch, shape, mesh):
    """Rules, batch axes, activation specs (without microbatches, with
    the cell's own count and with two), cache specs and notes."""
    m = _mesh(mesh)
    cfg, jcfg = get_config(arch), jax_config(arch)
    s, js = SHAPES[shape], JSHAPES[shape]
    sizes = SH.mesh_sizes(m)
    assert SH.sharding_rules(cfg, sizes) == JSH.sharding_rules(jcfg, sizes)
    assert SH.batch_axes(sizes, s.global_batch) \
        == JSH.batch_axes(sizes, js.global_batch)
    ga = choose_grad_accum(cfg, s, sizes)
    assert ga == jax_choose_grad_accum(jcfg, js, sizes)
    for kw in ({}, {"grad_accum": ga}, {"grad_accum": 2}):
        _same(SH.activation_shardings(cfg, m, s, **kw),
              JSH.activation_shardings(jcfg, m, js, **kw))
    _same(SH.cache_specs(cfg, m, s), JSH.cache_specs(jcfg, m, js))
    assert SH.check_divisibility(cfg, m, s) \
        == JSH.check_divisibility(jcfg, m, js)


def test_param_shapes_hold_no_memory():
    defs = M.model_defs(get_config("llama3-405b"))
    shapes = dict(PR.leaves(PR.param_shapes(defs)))
    for path, d in PR.leaves(defs):
        t = shapes[path]
        assert t.device.type == "meta", path
        assert (tuple(t.shape), t.dtype) == (d.shape, d.dtype), path
    assert sum(t.numel() for t in shapes.values()) \
        == M.count_model_params(get_config("llama3-405b"))


@pytest.mark.parametrize("parts", [
    (), (None,), ("data",), (("data",), None, "model"), ((),),
    (("pod", "data"), None), (["model"], ("pod", "data", "model"))])
def test_partition_spec_normalizes_as_jax(parts):
    assert tuple(SH.PartitionSpec(*parts)) == tuple(JP(*parts))


def test_placements_map_a_spec_onto_the_mesh():
    from torch.distributed.tensor import Replicate, Shard
    m = StandInMesh((2, 16, 16), ("pod", "data", "model"))
    P = SH.PartitionSpec
    assert SH.placements(P(("pod", "data"), None, "model"), m) \
        == (Shard(0), Shard(0), Shard(2))
    assert SH.placements(P(None, "data"), m) \
        == (Replicate(), Shard(1), Replicate())
    assert SH.placements(P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements(P(("data", "pod")), m)


def test_cst_without_a_spec_is_the_identity():
    x = torch.ones(2, 3)
    for shardings in (None, {}, {"residual": None}):
        assert M.cst(x, shardings, "residual") is x
    spec = {"residual": SH.PartitionSpec("data", None)}
    assert M.cst(x, spec, "residual") is x      # not a DTensor
