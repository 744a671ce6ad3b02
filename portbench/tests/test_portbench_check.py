"""What decides ``correct``: the plain reference against the port, its
control, and runs of the harness with the timed path broken underneath
(on the CPU, at a size a test run can hold)."""
import time

import numpy as np
import pytest

from portbench_tiny import one_thread, tiny_plan  # noqa: F401
from repro_torch.core import run_sweep, sim, sweep

CELL = {"homa": "homa144-w3-b320", "pfabric": "pfabric144-w3-b480"}
pytestmark = pytest.mark.usefixtures("one_thread")


def reference(p, tables, early=0):
    """The reference's rows of every run of ``tables``."""
    rows = p.reference.run(p.config, tables, p.traffic["streaming"],
                           p.traffic["chunk_slots"], True,
                           list(range(len(tables))), "cpu", early=early)
    return {i: {**r, "n_messages": len(tables[i]["size"])}
            for i, r in enumerate(rows)}


def outputs(p, seed=5):
    """(the port's SweepStats on the CPU, the reference's rows) of every
    run of plan ``p``'s grid."""
    tables = p.generator.tables(p.traffic, p.config, seed)
    cfg, spec = p.runner.program(p.config, tables, p.traffic, "cpu")
    return run_sweep(cfg, spec), reference(p, tables)


@pytest.mark.parametrize("protocol,hosts", [
    ("homa", 8), ("pfabric", 8), ("homa", 16), ("pfabric", 16)])
def test_reference_matches_the_port(protocol, hosts):
    p = tiny_plan(CELL[protocol], hosts=hosts, slots=250, msgs=120,
                  loads=(0.9,))
    got, want = outputs(p)
    bad, runs_bad = p.runner.judge([got], want, p.config, p.reference,
                                   len(got))
    assert (bad, runs_bad) == (0, 0)
    assert sum(s.n_complete for s in got) > 0     # traffic went through
    assert np.asarray(got[-1].hist).sum() > 0


@pytest.mark.parametrize("protocol", ["homa", "pfabric"])
def test_control_fails(protocol):
    """The control (the reference with its drains one slot early, past
    the stated link delays) in the program's place is not correct."""
    p = tiny_plan(CELL[protocol], slots=200, msgs=120, loads=(0.9,))
    tables = p.generator.tables(p.traffic, p.config, 11)
    want = reference(p, tables)
    control = reference(p, tables, early=1)
    # control rows stand in for the program's integers
    bad = sum(p.runner.mismatches(control[i], want[i]) for i in want)
    assert bad > 0


def drive(p, seed=2 ** 31 + 3):
    t0 = time.perf_counter()
    return p.runner.run(p, seed=seed, seconds=0.0, trace=False,
                        device="cpu", t_start=t0)


def test_sound_run_is_correct():
    r = drive(tiny_plan("homa144-w3-b320", slots=200, msgs=120))
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["mismatched_ints"] == {"value": 0, "limit": 0}


def _unchanged_step(cfg, proto, S, n_sched, st, now, fx=None):
    return st


def _half_batch(orig):
    """Steps the first half of a batch and hands its rows to the rest."""
    def run_block(cfg, proto, spec, prepped, tables, idxs, n_sched):
        half = max(len(idxs) // 2, 1)
        rows = orig(cfg, proto, spec, prepped, tables, idxs[:half], n_sched)
        take = np.arange(len(idxs)) % half
        return {k: v[take] for k, v in rows.items()}
    return run_block


def _altered_answer(orig):
    def summary(cfg, st, acc):
        out = orig(cfg, st, acc)
        out["n_complete"] = out["n_complete"].clone()
        out["n_complete"][-1] += 1
        return out
    return summary


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer"])
def test_broken_program_is_not_correct(fault, monkeypatch):
    """Each fault a sweep cell can have makes ``correct`` false. (The
    exchange between chips has no fault here: every cell takes one.)"""
    if fault == "unchanged_step":
        monkeypatch.setattr(sim, "step_fn", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(sweep, "_run_block",
                            _half_batch(sweep._run_block))
    else:
        monkeypatch.setattr(sweep, "_device_summary",
                            _altered_answer(sweep._device_summary))
    r = drive(tiny_plan("pfabric144-w3-b480", slots=200, msgs=120))
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_ints"]["value"] > 0
