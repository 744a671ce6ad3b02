"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.inputs``,
``launch.mesh``) on the CPU.

- Every input leaf of every non-skipped cell on both production meshes
  has the global shape, dtype, placement and shard shape of the JAX
  package's ``input_specs`` (dumped by a subprocess with 512 host
  devices, as ``tests/test_dryrun.py`` builds them), and the bytes the
  dry run counts as a cell's arguments are those shards' bytes.
- JAX's own assertions on its test cell (``tests/test_dryrun.py``):
  ``whisper-small x decode_32k`` ends ``ok`` on both meshes.
- Invariants on reduced configs: one device issues no collective; a
  data-parallel prefill splits the FLOPs four ways; a data-parallel
  train step syncs exactly its gradients; the trace on a (1, 1) mesh
  costs what the plain step costs.
- The plan computes the same function: on a 2 x 2 gloo world of four
  CPU processes the sharded fp32 prefill and train step match the
  single-process ones.
- No fake process group is left behind.

On a PyTorch built for the CPU only, fake CUDA tensors cannot take
Python indexing, so the dry runs here trace for the CPU (``--device
cpu``); the card's host traces for ``cuda`` (``chip_smoke.py`` phase 14).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_NAMES
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_is_skipped
from repro_torch.configs.reduced import reduced_config
from repro_torch.distrib import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.inputs import input_specs
from repro_torch.launch.mesh import fake_mesh, host_group, production_mesh
from repro_torch.models import model as M
from repro_torch.models.params import init_params, leaves
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.step import build_prefill_step, build_train_step

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}

JAX_DUMP = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import ARCH_NAMES
from repro.configs.base import SHAPES, cell_is_skipped
from repro.launch.mesh import make_production_mesh
from repro.launch.inputs import input_specs
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a in ARCH_NAMES:
        for s in SHAPES:
            if cell_is_skipped(a, s):
                continue
            flat, _ = jax.tree_util.tree_flatten_with_path(
                input_specs(a, s, mesh))
            out[f"{a}|{s}|{int(mp)}"] = [
                ["/".join(str(k.key) for k in path), list(x.shape),
                 str(x.dtype),
                 [list(e) if isinstance(e, tuple) else e
                  for e in x.sharding.spec],
                 list(x.sharding.shard_shape(x.shape))]
                for path, x in flat]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "inputs.json"
    r = subprocess.run([sys.executable, "-c", JAX_DUMP, str(path)],
                       capture_output=True, text=True, cwd=REPO,
                       env={**ENV, "JAX_PLATFORMS": "cpu"}, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _spec(entries):
    return SH.PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                              for e in entries])


def _shard_bytes(rows, keys) -> int:
    size = {"bfloat16": 2, "float32": 4, "int32": 4}
    return sum(math.prod(shard) * size[dt] for path, _, dt, _, shard in rows
               if path.split("/")[0] in keys)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_leaves_match_jax(jax_inputs, multi_pod):
    """Every leaf, one for one: path, global shape, dtype, placements of
    JAX's spec and rank 0's shard shape; and the argument bytes the dry
    run counts for each cell."""
    n_cells = 0
    with production_mesh(multi_pod, device="cpu") as mesh, FakeTensorMode():
        for a in ARCH_NAMES:
            for s in SHAPES:
                if cell_is_skipped(a, s):
                    continue
                want = jax_inputs[f"{a}|{s}|{int(multi_pod)}"]
                specs = input_specs(a, s, mesh)
                got = _paths(specs)
                assert [p for p, _ in got] == [w[0] for w in want], (a, s)
                for (path, t), (_, shape, dt, spec, shard) in zip(got, want):
                    where = (a, s, path)
                    assert list(t.shape) == shape, where
                    assert str(t.dtype).removeprefix("torch.") == dt, where
                    assert tuple(t.placements) == SH.placements(
                        _spec(spec), mesh), where
                    assert list(t.to_local().shape) == shard, where
                keys = D.ARG_KEYS[SHAPES[s].kind]
                assert D.local_bytes([specs[k] for k in keys]) \
                    == _shard_bytes(want, keys), (a, s)
                n_cells += 1
    assert n_cells == 33


@pytest.fixture(scope="module")
def whisper_cells():
    """JAX's test cell through the port's command line, both meshes at
    once, each in its own process."""
    runs = {mp: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "decode_32k", "--device", "cpu"]
        + (["--multi-pod"] if mp else []), cwd=REPO, env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mp in (False, True)}
    out = {}
    for mp, p in runs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        out[mp] = json.loads(D.cell_path("whisper-small", "decode_32k",
                                         mp).read_text())
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_whisper_decode_cell(whisper_cells, jax_inputs, multi_pod):
    """``tests/test_dryrun.py``'s assertions on its cell, and the
    argument bytes against JAX's shards."""
    d = whisper_cells[multi_pod]
    assert d["status"] == "ok"
    assert d["n_chips"] == (512 if multi_pod else 256)
    assert d["cost"]["flops"] > 0
    assert d["memory"]["argument_size_in_bytes"] > 0
    # per-device bytes stay far below one full copy of params + caches
    # (whisper decode_32k: ~200 MB params + ~25 GB global KV caches)
    assert d["memory"]["argument_size_in_bytes"] < 4e9
    rows = jax_inputs[f"whisper-small|decode_32k|{int(multi_pod)}"]
    assert d["memory"]["argument_size_in_bytes"] \
        == _shard_bytes(rows, D.ARG_KEYS["decode"])
    assert d["peak_bytes"] == d["memory"]["argument_size_in_bytes"] \
        + d["memory"]["temp_size_in_bytes"]
    assert d["fits_80gb"] and d["mesh"] == ("2x16x16" if multi_pod
                                            else "16x16")
    assert d["collectives"]["total_bytes"] == sum(
        v["bytes"] for k, v in d["collectives"].items() if k != "total_bytes")


SMALL = ShapeConfig("small", 32, 8, "prefill")


def _measure(arch, kind, mesh_shape, **kw):
    shape = ShapeConfig("small", SMALL.seq_len, SMALL.global_batch, kind)
    with fake_mesh(mesh_shape, device="cpu") as mesh:
        return D.measure(reduced_config(arch), shape, mesh, **kw)


def _collectives(r) -> dict:
    return {k: (v["count"], v["bytes"]) for k, v in r["collectives"].items()
            if k != "total_bytes" and v["count"]}


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-lite-16b",
                                  "mamba2-130m"])
def test_one_device_issues_no_collective(arch, kind):
    r = _measure(arch, kind, (1, 1))
    assert _collectives(r) == {} and r["collectives"]["total_bytes"] == 0
    assert r["cost"]["flops"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-lite-16b",
                                  "mamba2-130m"])
def test_data_parallel_prefill_splits_the_work(arch):
    """On a (4, 1) data-only mesh each device does a quarter of the
    (1, 1) prefill's FLOPs of the same global batch, and issues no
    collective. DeepSeek's MoE routes over every token, as JAX's (its
    capacity and each token's place in an expert's buffer depend on all
    of them): each device gathers the layer's tokens (T x D bf16) and
    runs the router's T x D x E product on all T tokens, fills and reads
    its quarter of the capacity rows, and the combine's fp32 partial sums
    are reduce-scattered back onto the batch (T / 4 x D fp32 each);
    worked out by hand."""
    one = _measure(arch, "prefill", (1, 1))
    four = _measure(arch, "prefill", (4, 1))
    cfg = reduced_config(arch)
    if not cfg.num_experts:
        assert four["cost"]["flops"] * 4 == one["cost"]["flops"]
        assert _collectives(four) == {}
        return
    T, D_, E = SMALL.global_batch * SMALL.seq_len, cfg.d_model, \
        cfg.num_experts
    n_moe = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
    router = n_moe * 2 * T * D_ * E
    assert four["cost"]["flops"] * 4 == one["cost"]["flops"] + 3 * router
    assert _collectives(four) == {
        "all-gather": (n_moe, n_moe * T * D_ * 2),
        "reduce-scatter": (n_moe, n_moe * T // 4 * D_ * 4)}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_data_parallel_train_step_syncs_its_gradients(arch):
    """On the (4, 1) mesh (parameters replicated, the batch split four
    ways, one microbatch) the step's collectives are one all-reduce of
    each parameter's gradient in its dtype and one of the loss's fp32
    token count. (DeepSeek's MoE adds its routing's own traffic, see
    above, and is left out here.)"""
    r = _measure(arch, "train", (4, 1), accum=1)
    defs = leaves(M.model_defs(reduced_config(arch)))
    grad_bytes = sum(math.prod(d.shape) * d.dtype.itemsize for _, d in defs)
    assert _collectives(r) == {"all-reduce": (len(defs) + 1,
                                              grad_bytes + 4)}


@pytest.mark.parametrize("arch, kind", [("mamba2-130m", "train"),
                                        ("llama3.2-3b", "prefill"),
                                        ("deepseek-v2-lite-16b", "train")])
def test_one_device_trace_costs_the_plain_step(arch, kind):
    """On a (1, 1) mesh the sharded step costs what the plain step costs
    when the same counter traces it on plain fake tensors (chip_smoke.py
    phase 14b holds the prediction to the card): the same argument bytes
    and FLOPs, and temp bytes within the few fp32 scalars the sharded
    path keeps besides."""
    cfg = reduced_config(arch)
    shape = ShapeConfig("small", 32, 16, kind)
    accum = 2 if kind == "train" else None
    with fake_mesh((1, 1), device="cpu") as mesh:
        pred = D.measure(cfg, shape, mesh, accum=accum)
        with FakeTensorMode():
            specs = input_specs(cfg, shape, mesh)

            def plain(t):
                if isinstance(t, dict):
                    return {k: plain(v) for k, v in t.items()}
                return t.to_local().clone()
            args = tuple(plain(specs[k]) for k in D.ARG_KEYS[kind])
            step = (build_train_step(cfg, OptConfig(), shape=shape,
                                     grad_accum=accum) if kind == "train"
                    else build_prefill_step(cfg, use_kernel=False))
            _, counter, _ = D.trace_step(step, args, "cpu")
            arg_bytes = D.local_bytes(args)
    assert pred["memory"]["argument_size_in_bytes"] == arg_bytes
    assert pred["cost"]["flops"] == counter.flops
    assert abs(pred["memory"]["temp_size_in_bytes"] - counter.peak) <= 64


def _rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def test_sharded_steps_match_single_process(tmp_path):
    """Reduced Llama, DeepSeek and Mamba in fp32 on a 2 x 2 gloo world of
    four CPU processes, parameters and tokens placed by the plan and the
    activations pinned by its hooks. The prefill's logits and every
    cache equal the single-process plain prefill's within rel RMS 1e-5.
    One train step of two microbatches (fresh AdamW state) gives the
    single-process step's loss within 1e-5 and its first moments (the
    clipped gradients, scaled) within rel RMS 5e-5 a leaf (~7x the worst
    measured, 6.9e-6 on Mamba's ``w_z``): the sharded step cuts each data
    shard into the microbatches (``training.step._split``), so the
    single-process step gets the rows in that order, where its contiguous
    halves are the same microbatches (the MoE's load-balancing loss
    depends on which tokens share one)."""
    gen = torch.Generator().manual_seed(5)
    inputs, want = {}, {}
    # 2 data shards of 2 rows: microbatch 0 = rows 0 and 2, 1 = 1 and 3
    shardwise = [0, 2, 1, 3]
    for arch in ("llama3.2-3b", "deepseek-v2-lite-16b", "mamba2-130m"):
        cfg = reduced_config(arch)
        params = _map(lambda t: t.float(),
                      init_params(M.model_defs(cfg), gen, "cpu"))
        tokens, labels = (torch.randint(0, cfg.vocab_size, (4, 32),
                                        generator=gen, dtype=torch.int32)
                          for _ in range(2))
        inputs[arch] = {"params": params, "tokens": tokens, "labels": labels}
        oc = OptConfig()
        _, opt, metrics = build_train_step(cfg, oc, grad_accum=2)(
            params, init_opt_state(params, oc),
            {"tokens": tokens[shardwise], "labels": labels[shardwise]})
        want[arch] = (build_prefill_step(cfg, use_kernel=False)(
            params, {"tokens": tokens}), metrics["loss"], opt["m"])
    torch.save(inputs, tmp_path / "inputs.pt")
    r = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "torch_sharded_worker.py"),
                        str(tmp_path)], env=ENV, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    for arch, ((logits, caches), loss, m) in want.items():
        g = got[arch]
        # the table is really split: vocab over "model"
        assert g["embed"][1] == "S(0)", g["embed"]
        assert _rel_rms(g["logits"], logits) <= 1e-5, arch
        for (path, c), (_, gc) in zip(_paths(caches), _paths(g["caches"])):
            assert gc.shape == c.shape, (arch, path)
            assert _rel_rms(gc, c) <= 1e-5, (arch, path)
        assert abs(float(g["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        for (path, a), (_, b) in zip(_paths(g["m"]), _paths(m)):
            assert _rel_rms(a, b) <= 5e-5, (arch, path)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_run_cell_leaves_no_group():
    d = D.run_cell("mamba2-130m", "long_500k", False, device="cpu")
    assert d["status"] == "ok" and d["n_chips"] == 256
    assert not dist.is_initialized()
    with host_group("cpu") as g:
        assert dist.get_world_size(g) == 1


def test_production_mesh_refuses_an_initialized_group():
    with host_group("cpu"):
        with pytest.raises(RuntimeError, match="already initialized"):
            with production_mesh(device="cpu"):
                pass
    assert not dist.is_initialized()
    with production_mesh(True, device="cpu") as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()


def test_skipped_cell_is_recorded_as_skipped():
    d = D.run_cell("llama3.2-3b", "long_500k", True, device="cpu")
    assert d["status"] == "skipped" and d["reason"] == cell_is_skipped(
        "llama3.2-3b", "long_500k")
    assert not dist.is_initialized()
