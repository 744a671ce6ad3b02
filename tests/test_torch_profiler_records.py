"""``chip_smoke.py``'s accounting of profiler windows (ROADMAP C6), on
stand-ins for the profiler: every view's count of a kernel's records
against the calls made in the window, and which call a short window
lost, by the records' grids and the idle gaps they leave."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

ENC = ((4, 1500, 12, 64), (4, 1500, 12, 64), False)
SELF = ((4, 448, 12, 64), (4, 448, 12, 64), True)
CROSS = ((4, 448, 12, 64), (4, 1500, 12, 64), False)
WHISPER = [ENC] * 12 + [SELF, CROSS] * 12
VSELF = ((2, 4096, 64, 128), (2, 4096, 8, 128), True)
VCROSS = ((2, 4096, 64, 128), (2, 6400, 8, 128), False)
VISION = [VSELF] * 4 + [VCROSS]
GRID = {ENC: [24, 48, 1], SELF: [7, 48, 1], CROSS: [7, 48, 2],
        VSELF: [32, 128, 1], VCROSS: [32, 128, 2]}


def _records(calls, lost=()):
    """Time-ordered trace records of ``calls`` less those in ``lost``: a
    launch every 100 us, 10 us long (a lost launch's time stays idle)."""
    return [{"ts": 100.0 * i, "dur": 10.0, "args": {"grid": GRID[s]}}
            for i, s in enumerate(calls) if i not in lost]


@pytest.mark.parametrize("calls,lost,index,position", [
    (WHISPER, 5, 5, "middle"),          # inside the encoder's run
    (WHISPER, 13, 13, "middle"),        # a call alone in its run
    (WHISPER, 35, 35, "last"),
    (VISION, 2, 2, "middle"),
    (VISION, 4, 4, "last"),             # Vision's one cross call
])
def test_the_missing_launch_is_named(calls, lost, index, position):
    got = cs._missing_launches(calls, _records(calls, {lost}))
    assert got["missing"] == 1 and lost in got["candidates"]
    if got["index"] is not None:
        assert (got["index"], got["position"]) == (index, [position])
    else:       # even gaps: the run's first or last, both named
        assert index in (got["candidates"][0], got["candidates"][-1])
        assert position in got["position"]
    assert calls[index] in got["shape"]


def test_a_lost_first_launch_is_one_end_of_its_run():
    got = cs._missing_launches(WHISPER, _records(WHISPER, {0}))
    assert got["index"] is None and got["candidates"] == list(range(12))
    assert got["position"] == ["first", "middle"]


def test_several_missing_are_counted_by_grid():
    got = cs._missing_launches(VISION, _records(VISION, {0, 4}))
    assert got == {"missing": 2,
                   "records_by_grid": {str(tuple(GRID[VSELF])): 3}}


def _event(name, cuda=True):
    dt = torch.autograd.DeviceType.CUDA if cuda \
        else torch.autograd.DeviceType.CPU
    return SimpleNamespace(key=name, name=name, count=1, device_type=dt,
                           device_time_total=5.0)


class _Prof:
    """A profiler window's three views, and its trace export."""

    def __init__(self, names, kineto_names, trace):
        self._ev = [_event(n) for n in names]
        self._kin = [SimpleNamespace(
            name=lambda n=n: n,
            device_type=lambda: torch.autograd.DeviceType.CUDA)
            for n in kineto_names]
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: self._kin))
        self._trace = trace

    def key_averages(self):
        return self._ev

    def events(self):
        return self._ev

    def export_chrome_trace(self, path):
        Path(path).write_text(json.dumps({"traceEvents": self._trace}))


def test_a_complete_window_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "ROOT", tmp_path)
    k = "flash_attention_tc_kernel<1, 1>"
    rec = cs._launch_records(_Prof([k] * 5 + ["gemm"],
                                   [k] * 5 + [cs.MARKER] * 3, []),
                             "flash_attention_tc_kernel", VISION, "t")
    assert rec == {"calls": 5, "key_averages": 5, "events": 5, "kineto": 5,
                   "markers": 3}
    assert not (tmp_path / "chiprun_out").exists()


def test_a_short_window_keeps_its_trace_and_names_the_launch(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(cs, "ROOT", tmp_path)
    k = "flash_attention_tc_kernel<1, 1>"
    trace = [dict(r, cat="kernel", name=k)
             for r in _records(VISION, {4})] \
        + [{"cat": "kernel", "name": "gemm", "ts": 1.0, "dur": 1.0,
            "args": {}}]
    rec = cs._launch_records(_Prof([k] * 4, [k] * 4, trace),
                             "flash_attention_tc_kernel", VISION, "13c_0")
    assert (rec["key_averages"], rec["kineto"], rec["trace"]) == (4, 4, 4)
    assert rec["missing"]["candidates"][-1] == 4
    assert (tmp_path / "chiprun_out" / "c6_13c_0.json").is_file()


def test_the_marker_is_left_out_of_the_device_events():
    prof = SimpleNamespace(key_averages=lambda: [
        _event(f"void at::cuda::{cs.MARKER}(long)"), _event("gemm"),
        _event("aten::mm", cuda=False)])
    assert [e[0] for e in cs._device_events(prof)] == ["gemm"]
