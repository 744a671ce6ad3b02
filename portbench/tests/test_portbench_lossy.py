"""The lossy cell's reference (``portbench/reference/lossy_sim.py``) held to
the JAX package's fault golden, a lossy cell made of new files only run
through ``runners/lossy_sweep.py`` on the CPU, planted faults in the
program that it must catch, and what the reference refuses."""
import json
import shutil
import time

import numpy as np
import pytest

from portbench_tiny import ROOT, one_thread  # noqa: F401
from portbench import harness
from portbench.gen import poisson
from repro_torch.core import fabric, faults, protocols

pytestmark = pytest.mark.usefixtures("one_thread")
PKG = ROOT / "portbench"
GOLDEN = json.loads((ROOT / "tests" / "golden"
                     / "faults_enabled.json").read_text())["small"]
MODELED = ("homa-lossy-ecmp", "homa-windows-ecmp", "homa-windows-flowlet",
           "pfabric-lossy-ecmp")
lossy = harness.load_module("reference", "lossy_sim")
LOSSY_CFG = json.loads((PKG / "configs"
                        / "homa-lossy-leafspine144.json").read_text())


def golden_config(meta: dict, run: dict) -> dict:
    """A golden run's configuration as a benchmark configuration: the
    simulator's defaults where the golden states nothing."""
    cfg = dict(LOSSY_CFG, n_hosts=meta["n_hosts"],
               slot_bytes=meta["slot_bytes"], protocol=run["protocol"],
               ring_cap=meta["ring_cap"], max_slots=meta["max_slots"])
    cfg["fabric"] = dict(LOSSY_CFG["fabric"], racks=meta["racks"],
                         oversub=meta["oversub"], up_cap=meta["up_cap"],
                         routing=run["routing"], faults=run["faults"])
    return cfg


@pytest.mark.parametrize("name", MODELED)
def test_reference_matches_the_fault_golden(name):
    """Per-message completions, retransmissions and fault drops, and the
    loss totals, equal the JAX package's exactly."""
    run, = [r for r in GOLDEN["runs"] if r["name"] == name]
    m = GOLDEN["meta"]
    table = poisson.make_table(m["workload"], n_hosts=m["n_hosts"],
                               load=m["load"], n_messages=m["n_messages"],
                               slot_bytes=m["slot_bytes"], seed=m["seed"])
    st = lossy.final_state(golden_config(m, run), table)
    got = {"completion": st["completion"].tolist(),
           "retx_chunks": st["retx"].tolist(),
           "msg_lost_chunks": st["msg_lost"].tolist(),
           "fault_lost_chunks": int(st["f_lost"]),
           "lost_chunks": int(st["lost"]) + int(st["u_lost"]),
           "tor_up_lost_chunks": int(st["u_lost"])}
    assert [k for k in got if got[k] != run[k]] == []
    assert got["fault_lost_chunks"] > 0
    assert int(st["rw_resend"]) + int(st["rw_timeout"]) > 0
    assert (int(st["rw_resend"]) > 0) == (run["protocol"] == "homa")


TINY_FAULTS = {"up_loss": 0.02, "down_loss": 0.01, "ge_p_gb": 0.005,
               "ge_p_bg": 0.1, "ge_loss": 0.5, "link_fail": [[5, 60, 300]],
               "tor_fail": [[1, 100, 200]], "resend_slots": 40,
               "sender_timeout_slots": 90, "seed": 3}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The lossy configuration cut to 8 hosts in 2 racks, 400 slots,
    16-slot flowlets, short timers and windows inside the run, with a
    mix of 4 runs of 120 W3 messages: new files and new entries in a
    copy of the benchmark."""
    tmp = tmp_path_factory.mktemp("lossy")
    base = tmp / "portbench"
    shutil.copytree(PKG, base, ignore=shutil.ignore_patterns(
        "__pycache__", "out", "tests"))
    cfg = dict(LOSSY_CFG, name="homa-lossy8", n_hosts=8, max_slots=400,
               reduced={})
    cfg["fabric"] = dict(cfg["fabric"], racks=2, flowlet_slots=16,
                         faults=TINY_FAULTS)
    (base / "configs/homa-lossy8.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic/w3-sweep-b320.json").read_text())
    mix.update(name="w3-tiny", loads=[0.6, 0.9], seeds_per_load=2,
               n_messages=120, check_runs_per_load=2, chunk_slots=150)
    (base / "traffic/w3-tiny.json").write_text(json.dumps(mix))
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "homa-lossy8", "source": "test",
                             "file": "portbench/configs/homa-lossy8.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "homa8-lossy", "config": "homa-lossy8",
                               "traffic": "w3-tiny", "chips": 1,
                               "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.plan(harness.load_benchmark(tmp), "homa8-lossy",
                        root=tmp, base=base)


def drive(p):
    return p.runner.run(p, seed=2 ** 33 + 7, seconds=0.0, trace=False,
                        device="cpu", t_start=time.perf_counter())


def test_a_lossy_cell_of_new_files_only(tiny):
    """The program on the CPU equals the reference in every integer, the
    fault counters among them, and every kind of recovery fires."""
    r = drive(tiny)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["mismatched_ints"] == {"value": 0, "limit": 0}
    mix = tiny.traffic
    tables = tiny.generator.tables(mix, tiny.config, 2 ** 33 + 7)
    rows = tiny.reference.run(tiny.config, tables, mix["streaming"],
                              mix["chunk_slots"], True,
                              list(range(len(tables))), "cpu")
    for k in ("f_lost", "retx", "rw_resend", "rw_timeout"):
        assert sum(int(row[k]) for row in rows) > 0, k
    assert all(row["f_lost"] > 0 for row in rows)


def _late_resend(self, cfg, st, S, now, known, quiet):
    return known & (quiet >= cfg.fabric.faults.resend_slots + 1)


def _plan_epoch_ahead(orig):
    def plan(cfg, M, t, e):
        return orig(cfg, M, t, e + 1)
    return plan


def _no_forward_loss(cfg, st, msg, dst, any_e, now, fx):
    return any_e, st


PLANTED = {
    "resend-one-slot-late": (protocols.OvercommitSrptReceiver, "resend",
                             _late_resend),
    "flowlet-epoch-off-by-one": (faults, "_plan",
                                 _plan_epoch_ahead(faults._plan)),
    "forwarding-loss-skipped": (fabric, "forward_losses", _no_forward_loss),
}


@pytest.mark.parametrize("fault", list(PLANTED))
def test_planted_faults_are_not_correct(tiny, fault, monkeypatch):
    monkeypatch.setattr(*PLANTED[fault])
    r = drive(tiny)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_ints"]["value"] > 0


@pytest.mark.parametrize("change,why", [
    (dict(routing="adaptive"), "routing 'adaptive'"),
    (dict(host="kernel_stack"), "a host stage"),
    (dict(trace={"stride": 16}), "telemetry"),
    (dict(fabric=None), "the single switch"),
    (dict(protocol="phost"), "protocol 'phost'"),
])
def test_check_supported_refuses(change, why):
    cfg = dict(LOSSY_CFG)
    if "routing" in change:
        cfg["fabric"] = dict(cfg["fabric"], routing=change.pop("routing"))
    cfg.update(change)
    with pytest.raises(ValueError, match=why):
        lossy.check_supported(cfg)


@pytest.mark.parametrize("protocol", ["homa", "pfabric"])
@pytest.mark.parametrize("routing", ["ecmp", "flowlet"])
@pytest.mark.parametrize("with_faults", [True, False])
def test_check_supported_accepts(protocol, routing, with_faults):
    cfg = dict(LOSSY_CFG, protocol=protocol)
    cfg["fabric"] = dict(cfg["fabric"], routing=routing,
                         faults=cfg["fabric"]["faults"] if with_faults
                         else None)
    lossy.check_supported(cfg)


def test_draws_are_the_hash_of_row_and_slot():
    """The same rows and slots draw the same, whatever the run's length;
    the flowlet uplink changes at each epoch for some message; the
    failure windows darken their rows for their slots only."""
    cfg = dict(LOSSY_CFG)
    a = lossy.draws(cfg, 50, 1100, "cpu")
    b = lossy.draws(cfg, 50, 70, "cpu")
    for k in b:
        assert np.array_equal(a[k][:b[k].shape[0]].numpy(), b[k].numpy()), k
    fl = a["flowlet"].numpy()
    assert fl.shape == (18, 50) and (fl[0] != fl[1]).any()
    assert fl.min() >= 0 and fl.max() < lossy.n_uplinks(cfg)
    host, link = a["host_down"].numpy(), a["link_down"].numpy()
    dark = np.zeros_like(host)
    dark[600:1000, 48:64] = True                     # TOR 3's hosts
    assert np.array_equal(host, dark)
    dark = np.zeros_like(link)
    dark[400:1600, 5] = True                         # uplink 5
    dark[600:1000, 48:64] = True                     # its 16 uplinks
    assert np.array_equal(link, dark)
    assert 0 < a["lose_up"].float().mean() < 0.02
    assert a["ge_bad"].any() and not a["ge_bad"].all()
