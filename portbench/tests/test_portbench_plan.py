"""BENCHMARK.json against the benchmark's contract, finding every file by
name, a cell made only of new files, the import check and the result's
last line."""
import ast
import hashlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench_tiny import ROOT, one_thread  # noqa: F401
from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PKG = ROOT / "portbench"


def test_benchmark_file_meets_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "portbench/run.py"
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] == "device_trace"
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_is_found_by_name(cell):
    p = harness.plan(BENCH, cell)
    assert p.config["name"] == p.cell["config"]
    assert p.traffic["name"] == p.cell["traffic"]
    assert [m["name"] for m, _ in p.per_layer] == \
        [m["name"] for m in BENCH["per_layer"]]
    assert [m["name"] for m in p.end_to_end] == \
        [m["name"] for m in BENCH["end_to_end"]]
    assert len(p.generator.tables(dict(p.traffic, n_messages=10), p.config,
                                  1)) == len(p.traffic["loads"]) \
        * p.traffic["seeds_per_load"]


def _digests(d):
    return {str(f.relative_to(d)): hashlib.sha256(f.read_bytes()).digest()
            for f in d.rglob("*") if f.is_file()
            and "__pycache__" not in f.parts}


def test_a_cell_of_new_files_only(tmp_path, one_thread):
    """A new configuration, traffic mix and per-layer metric, added as
    new files and new entries, plan and run on the CPU; no file the
    benchmark had changes."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out",
                                                  "tests"))
    before = _digests(tmp_path / "portbench")
    base = tmp_path / "portbench"
    cfg = json.loads((base / "configs/homa-leafspine144.json").read_text())
    cfg.update(name="homa-fabric8", n_hosts=8, max_slots=200, reduced={},
               fabric=dict(cfg["fabric"], racks=4, oversub=2.0))
    (base / "configs/homa-fabric8.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic/w3-sweep-b320.json").read_text())
    mix.update(name="w1-tiny", workload="W1", loads=[0.8],
               seeds_per_load=2, n_messages=80, check_runs_per_load=2,
               chunk_slots=64)
    (base / "traffic/w1-tiny.json").write_text(json.dumps(mix))
    (base / "metrics/slots_traced.py").write_text(
        "def read(rec):\n    return rec['slots']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "homa-fabric8", "source": "test",
                             "file": "portbench/configs/homa-fabric8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "homa8-w1", "config": "homa-fabric8",
                               "traffic": "w1-tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "slots_traced", "unit": "slots",
                               "better": "higher", "source": "device_trace",
                               "layer": "slot loop", "moves": "sweep_rate",
                               "workloads": ["homa8-w1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(base)
    assert all(after[f] == d for f, d in before.items())
    p = harness.plan(harness.load_benchmark(tmp_path), "homa8-w1",
                     root=tmp_path, base=base)
    assert p.config["n_hosts"] == 8 and p.traffic["workload"] == "W1"
    assert [m["name"] for m, _ in p.per_layer][-1] == "slots_traced"
    assert p.per_layer[-1][1].read({"slots": 40}) == 40
    # another cell does not report the new metric
    assert "slots_traced" not in [
        m["name"] for m, _ in harness.plan(
            harness.load_benchmark(tmp_path), "homa144-w3-b320",
            root=tmp_path, base=base).per_layer]

    result = p.runner.run(p, seed=2 ** 33 + 1, seconds=0.0, trace=False,
                          device="cpu", t_start=time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(result)
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert last["correct"] is True and last["attempted"] == 2
    assert set(last["metrics"]) == {"sweep_rate", "peak_mem_gb", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in last["metrics"].values())
    assert err.getvalue().splitlines()[-1] == \
        "check mismatched_ints: 0 (limit 0)"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_nothing_of_the_jax_package():
    for f in PKG.rglob("*.py"):
        if "tests" in f.relative_to(PKG).parts:
            continue
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & set(harness.FORBIDDEN), f
        # nothing here reads the JAX package's benchmark folder
        assert not re.search(r"""benchmarks['"/]""", f.read_text()), f
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core.sim", "numpy", "portbench"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core", "jaxlib.xla_client", "jax",
         "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr
