"""The port's examples and trace export (``examples/torch_*.py``,
``scripts/torch_export_trace.py``), each run on ``--device cpu`` at small
flags in a subprocess, all at once, against the JAX package:

- the homa/basic mini Fig. 12 and the fabric incast tables equal the
  JAX package's ``simulate`` at the same sizes, printed by the example's
  own line functions (the JAX scripts' fixed horizons, 60000 and 16000
  slots, cost minutes);
- the quickstart's simulator tour equals ``examples/quickstart.py``'s
  ``sim_quickstart`` (its training run restarts from a checkpoint);
- the serve demo's output (the scheduler's statistics, which do not
  depend on the model) equals ``examples/serve_demo.py``'s;
- the exported Perfetto and time-series JSON are byte for byte the
  files ``scripts/export_trace.py`` writes for the same run.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import FabricConfig as JFabricConfig
from repro.core import SimConfig as JSimConfig
from repro.core import make_messages as jmake_messages
from repro.core import scenarios as jscenarios
from repro.core import simulate as jsimulate

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "2"}
HOMA_ARGV = ["--messages", "100", "--max-slots", "1500"]
FABRIC_ARGV = ["--bursts", "2", "--background", "100", "--max-slots", "2500"]
TRACE_ARGV = ["--n-messages", "60", "--max-slots", "600", "--out",
              "trace.json"]
RUNS = {   # name: (script, argv, the JAX package's script or None)
    "homa": ("examples/torch_homa_network_sim.py", HOMA_ARGV, None),
    "fabric": ("examples/torch_fabric_incast.py", FABRIC_ARGV, None),
    "quickstart": ("examples/torch_quickstart.py",
                   ["--steps", "8", "--ckpt-every", "2"], None),
    "serve": ("examples/torch_serve_demo.py", [], "examples/serve_demo.py"),
    "perfetto": ("scripts/torch_export_trace.py", TRACE_ARGV,
                 "scripts/export_trace.py"),
    "timeseries": ("scripts/torch_export_trace.py",
                   TRACE_ARGV + ["--timeseries"], "scripts/export_trace.py"),
}


def _load(rel: str):
    """An example file as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> {"port": (stdout, its directory), "jax": ...}: every
    script started at once, each in a directory of its own."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {}
    for name, (script, argv, jax_script) in RUNS.items():
        for side, path, extra in (("port", script, ["--device", "cpu"]),
                                  ("jax", jax_script, [])):
            if path is None:
                continue
            cwd = tmp / f"{name}_{side}"
            cwd.mkdir()
            procs[name, side] = cwd, subprocess.Popen(
                [sys.executable, str(REPO / path), *argv, *extra],
                cwd=cwd, env=ENV, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for (name, side), (cwd, p) in procs.items():
            stdout, stderr = p.communicate(timeout=400)
            assert p.returncode == 0, f"{name} {side}: {stderr[-3000:]}"
            out.setdefault(name, {})[side] = (stdout, cwd)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_homa_network_sim_equals_jax(runs):
    ex = _load("examples/torch_homa_network_sim.py")
    tbl = jmake_messages("W3", n_hosts=8, load=0.8, n_messages=100,
                         slot_bytes=256, seed=1)
    want = ["workload W3 @ 80% load, 100 messages, 8 hosts"]
    results = {}
    for proto in ("homa", "basic"):
        results[proto] = jsimulate(JSimConfig(
            n_hosts=8, protocol=proto, max_slots=1500, ring_cap=2048), tbl)
        want += ex.protocol_lines(proto, results[proto])
    want += ex.comparison_lines(results)
    assert runs["homa"]["port"][0] == "\n".join(want) + "\n"


def test_fabric_incast_equals_jax(runs):
    ex = _load("examples/torch_fabric_incast.py")
    tbl = jscenarios.incast(12, 2048, n_hosts=16, n_bursts=2,
                            period_slots=1500, background="W2",
                            background_load=0.5, n_background=100, seed=2)
    fab = JFabricConfig(racks=4, oversub=2.0, up_cap=1024)
    got = runs["fabric"]["port"][0].splitlines()
    assert got[1] == f"traffic: {len(tbl.size)} messages (12-way incast " \
                     f"bursts of 2 KB + W2 background)"
    for proto, line in zip(("homa", "basic"), got[3:5]):
        r = jsimulate(JSimConfig(protocol=proto, n_hosts=16, max_slots=2500,
                                 ring_cap=1024, fabric=fab), tbl)
        assert line == ex.protocol_line(proto, r)


def test_quickstart_tour_equals_jax_and_restarts(runs):
    jq = _load("examples/quickstart.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jq.sim_quickstart()
    want = buf.getvalue().replace("(one jit trace)",
                                  "(one batch on the run axis)")
    got = runs["quickstart"]["port"][0]
    assert got.startswith(want)
    assert "[train] simulated preemption at step 4" in got
    assert "[train] resumed from step 4" in got
    assert "quickstart OK" in got


def test_serve_demo_equals_jax(runs):
    got, want = runs["serve"]["port"][0], runs["serve"]["jax"][0]
    assert got == want and "served 24/24" in got


@pytest.mark.parametrize("form", ["perfetto", "timeseries"])
def test_trace_export_equals_jax(runs, form):
    (got, gdir), (want, wdir) = runs[form]["port"], runs[form]["jax"]
    assert got == want
    assert (gdir / "trace.json").read_bytes() \
        == (wdir / "trace.json").read_bytes()
