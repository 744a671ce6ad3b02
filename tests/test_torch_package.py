"""Package rules of the port: no JAX and nothing of ``repro`` inside it,
no silent CPU fallback, and every option normalized or refused as the
JAX package does it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import (HOST_PRESETS, FabricConfig, HostConfig,
                              SimConfig, TraceConfig, WorkloadSpec,
                              make_messages, simulate)
from repro_torch.kernels.arbiter import build, dispatch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.arbiter.kernel, "
            "repro_torch.kernels.ssd.ops, repro_torch.kernels.attention.ops, "
            "repro_torch.models.model, repro_torch.configs.llama3_2_3b, "
            "repro_torch.launch.serve, repro_torch.core.hostmodel, "
            "repro_torch.core.telemetry, repro_torch.training.optimizer, "
            "repro_torch.training.step, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.store, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.distrib.homa_collectives, "
            "repro_torch.distrib.sharding, repro_torch.launch.inputs, "
            "repro_torch.launch.dryrun, repro_torch.tree; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro'))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    assert out.strip() == "[]"


def test_importing_the_dry_run_starts_no_process_group():
    """Like the JAX package's mesh module, which touches no device state,
    the sharding, inputs, mesh and dry-run modules start no process group
    when imported (``host_group`` would adopt one)."""
    code = ("import torch.distributed as dist, repro_torch.distrib.sharding, "
            "repro_torch.launch.inputs, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun; print(dist.is_initialized())")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    assert out.strip() == "False"


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py",
        ROOT / "tests" / "torch_sharded_worker.py",
        ROOT / "tests" / "torch_sweep_worker.py"] + sorted(
        (ROOT / "examples").glob("torch_*.py")) + sorted(
        (ROOT / "scripts").glob("torch_*.py"))
    for name in ("examples/torch_homa_gradient_sync.py",
                 "examples/torch_quickstart.py",
                 "examples/torch_homa_network_sim.py",
                 "examples/torch_fabric_incast.py",
                 "examples/torch_serve_demo.py",
                 "scripts/torch_export_trace.py",
                 "scripts/torch_profiler_c6.py"):
        assert ROOT / name in files, name
    assert len(files) > 10
    for mod in ("training/optimizer.py", "training/step.py",
                "data/pipeline.py", "checkpoint/store.py", "launch/train.py",
                "launch/mesh.py", "distrib/homa_collectives.py",
                "distrib/sharding.py", "launch/inputs.py",
                "launch/dryrun.py"):
        assert PORT / mod in files, mod
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"


def test_no_cuda_without_a_card(monkeypatch):
    """Without a card, the default device raises instead of running on
    the CPU; only an explicit ``device="cpu"`` runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimConfig(device="cuda")
    cfg = SimConfig(device="cpu")
    assert cfg.device == "cpu" and cfg.backend == "reference"


def test_backend_names_are_the_ports_own(monkeypatch):
    monkeypatch.setenv("SIM_BACKEND", "pallas")      # the JAX package's
    assert SimConfig(device="cpu").backend == "reference"
    assert SimConfig(device="cpu", backend="reference").backend \
        == "reference"
    with pytest.raises(ValueError, match="unknown backend"):
        SimConfig(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        SimConfig(device="cpu", backend="cuda")
    assert dispatch.resolve_backend(None, "cuda") == "cuda"
    with pytest.raises(ValueError, match="unsupported device"):
        SimConfig(device="meta")


@pytest.mark.parametrize("kw, want", [
    (dict(host="kernel_stack"), HOST_PRESETS["kernel_stack"]),
    (dict(host={"model": "cpu"}), HostConfig()),
    (dict(trace=object()), TypeError),
    (dict(host="kernel_bypass"), HOST_PRESETS["kernel_bypass"]),
    (dict(trace={"stride": 8}), TraceConfig(stride=8)),
])
def test_host_and_trace_options_normalize(kw, want):
    """``SimConfig.host`` takes a preset name or a dict and ``trace`` a
    dict, normalized to their configs as in the JAX package; anything
    else raises an error naming the field."""
    if want is TypeError:
        with pytest.raises(TypeError, match="SimConfig.trace"):
            SimConfig(device="cpu", **kw)
        return
    cfg = SimConfig(device="cpu", **kw)
    assert getattr(cfg, next(iter(kw))) == want


@pytest.mark.parametrize("make", [
    lambda: SimConfig(device="cpu", n_hosts=8, fabric=FabricConfig(
        racks=2, faults={"up_loss": 0.01})),
    lambda: SimConfig(device="cpu", n_hosts=8, fabric=FabricConfig(
        racks=2, routing="flowlet")),
    lambda: SimConfig(device="cpu", n_hosts=8, fabric=FabricConfig(
        racks=2, routing="adaptive")),
    lambda: WorkloadSpec(kind="incast", fan_in=3,
                         burst_bytes=1000).build(n_hosts=4),
    lambda: WorkloadSpec(kind="hotspot", workload="W1", load=0.5,
                         n_messages=10).build(n_hosts=4),
    lambda: WorkloadSpec(kind="shuffle", bytes_per_pair=500).build(
        n_hosts=4),
    lambda: make_messages("W1", n_hosts=4, load=0.5, n_messages=10,
                          slot_bytes=256, incast=(2, 1000, 100)),
])
def test_front_end_and_fault_options_are_ported(make):
    """The options ROADMAP A1 and A5 refused until they were ported now
    build (the tables and runs are held to JAX in test_torch_scenarios.py
    and test_torch_faults.py)."""
    assert make() is not None


def test_fused_backend_resolves():
    """The port's fused backend runs on either device: the kernel on a
    card, the plain fused version on the CPU."""
    assert SimConfig(device="cpu", backend="fused").backend == "fused"
    assert dispatch.resolve_backend("fused", "cuda") == "fused"
    assert dispatch.resolve_backend("fused", "cpu") == "fused"


def test_jax_fused_backend_name_is_rejected():
    """``pallas_fused`` is the JAX package's name; the port's is
    ``fused``."""
    with pytest.raises(ValueError, match="unknown backend"):
        SimConfig(device="cpu", backend="pallas_fused")


def test_other_bad_options_raise():
    with pytest.raises(ValueError, match="unknown routing"):
        FabricConfig(racks=2, routing="spray")
    with pytest.raises(ValueError, match="pallas_interpret"):
        SimConfig(device="cpu", pallas_interpret=True)
    with pytest.raises(ValueError, match="unknown protocol"):
        SimConfig(device="cpu", protocol="tcp")
    with pytest.raises(ValueError, match="not divisible"):
        SimConfig(device="cpu", n_hosts=10, fabric=FabricConfig(racks=3))
    assert SimConfig(device="cpu", host="ideal").host == HostConfig()


def test_ideal_host_and_single_rack_match_the_single_switch():
    """``host="ideal"``, ``FabricConfig(None)`` and one rack are the
    single switch, as in the JAX package."""
    tbl = make_messages("W2", n_hosts=4, load=0.7, n_messages=40,
                        slot_bytes=256, seed=2)
    base = simulate(SimConfig(device="cpu", n_hosts=4, max_slots=400), tbl)
    for kw in (dict(host="ideal"), dict(fabric=FabricConfig(None)),
               dict(fabric=FabricConfig(racks=1))):
        r = simulate(SimConfig(device="cpu", n_hosts=4, max_slots=400, **kw),
                     tbl)
        assert (r.completion == base.completion).all(), kw
        assert (r.q_max_bytes == base.q_max_bytes).all(), kw


def test_build_is_keyed_by_source_and_flags():
    """The library path hashes the source and flags into a directory that
    ``.gitignore`` lists; finding no nvcc raises instead of skipping the
    kernels."""
    path = build.library_path()
    assert path.parent.parent == build.BUILD_ROOT
    assert "src/repro_torch/kernels/_build/" in \
        (ROOT / ".gitignore").read_text().split()
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.Path, "is_file",
                        lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_one_builder_two_libraries():
    """Every kernel library goes through the one builder, each keyed on
    its own ``csrc/`` into its own directory under ``_build/``."""
    from repro_torch.kernels import build as builder
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    libs = (build.LIBRARY, ssd_kernel.LIBRARY, attn_kernel.LIBRARY)
    names = ("arbiter", "ssd", "attention")
    paths = [lib.library_path() for lib in libs]
    for lib, name, path in zip(libs, names, paths):
        assert isinstance(lib, builder.CudaLibrary)
        assert [f.name for f in lib.sources] == [f"{name}.cu"]
        assert path.parent.parent == builder.BUILD_ROOT
        assert path.name == f"lib{name}.so"
    assert len({p.parent for p in paths}) == 3
    assert build.library_path() == paths[0]
    # the tensor-core libraries include the shared Hopper header
    assert ssd_kernel.LIBRARY.include_dirs == (builder.COMMON,)
    assert attn_kernel.LIBRARY.include_dirs == (builder.COMMON,)
    assert (builder.COMMON / "hopper.cuh").is_file()
    assert not list(builder.COMMON.glob("*.cu"))


@pytest.mark.parametrize("edit", ["hopper.cuh", "ssd.cu", "attention.cu"])
def test_shared_header_keys_both_libraries(tmp_path, edit):
    """An edit of the shared header changes both tensor-core libraries'
    keys (each rebuilds); an edit of one library's source changes its own
    key only. Keys depend on file names and contents, not on where the
    checkout lies."""
    import shutil
    from repro_torch.kernels import build as builder
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    common = shutil.copytree(builder.COMMON, tmp_path / "common")
    libs = {}
    for name, mod in (("ssd", ssd_kernel), ("attention", attn_kernel)):
        csrc = shutil.copytree(mod.LIBRARY.csrc, tmp_path / name / "csrc")
        libs[name] = builder.CudaLibrary(name, csrc, mod._declare,
                                         include_dirs=(common,))
        assert libs[name].library_path() == mod.LIBRARY.library_path()
    before = {n: lib.library_path() for n, lib in libs.items()}
    target = {"hopper.cuh": common, "ssd.cu": libs["ssd"].csrc,
              "attention.cu": libs["attention"].csrc}[edit] / edit
    target.write_text(target.read_text() + "\n// edited\n")
    after = {n: lib.library_path() for n, lib in libs.items()}
    changed = {n for n in libs if after[n] != before[n]}
    assert changed == ({"ssd", "attention"} if edit == "hopper.cuh"
                       else {edit.removesuffix(".cu")})


def test_ssd_wrapper_rejects_other_devices():
    """The SSD wrapper runs its plain version only for a CPU tensor and
    raises on a device that is neither CPU nor CUDA."""
    from repro_torch.kernels.ssd.kernel import ssd_scan
    x = torch.zeros((1, 8, 1, 4), device="meta")
    dt = torch.zeros((1, 8, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd_scan(x, dt, torch.zeros(1, device="meta"),
                 torch.zeros((1, 8, 4), device="meta"),
                 torch.zeros((1, 8, 4), device="meta"), chunk=8)
