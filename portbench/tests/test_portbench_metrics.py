"""The per-layer metrics' readers on a canned trace, and the byte counts
of the arbitration roofline at PERF.md's shapes."""
import pytest

import portbench_tiny  # noqa: F401
from portbench import profiling
from portbench.harness import load_benchmark, load_module

NAMES = [m["name"] for m in load_benchmark()["per_layer"]]
roofline = load_module("metrics", "arbitration_roofline")
US = 1000                                   # ns


def canned():
    """Two slots in a 100 us span: a ring drain (10 us), a top-K
    (20 us), two elementwise kernels (10 us each, the second overlapping
    the top-K by 5 us) and a fill (5 us); idle from 0-10 and 65-100 us
    while the host launches."""
    return {
        "slots": 2, "span": (0, 100 * US),
        "device": [
            ("void priority_arbiter_kernel<64, 2>(...)", "kernel",
             10 * US, 20 * US),
            ("void srpt_topk_kernel<8>(...)", "kernel", 20 * US, 40 * US),
            ("elementwise_kernel", "kernel", 35 * US, 45 * US),
            ("elementwise_kernel", "kernel", 45 * US, 55 * US),
            ("Memset (Device)", "fill", 60 * US, 65 * US)],
        "host": [("aten::scatter_", 0, 12 * US),
                 ("cudaLaunchKernel", 64 * US, 70 * US),
                 ("aten::where", 66 * US, 100 * US)],
        "markers": 256,
        "cell": dict(B=2, H=4, cap=16, U=2, ucap=8, M=10, K=3)}


def test_every_per_layer_metric_has_a_reader():
    for name in NAMES:
        assert callable(load_module("metrics", name).read)


def test_readers_on_a_canned_trace():
    rec = canned()
    read = {n: load_module("metrics", n).read(rec) for n in NAMES}
    assert read["launches_per_slot"] == 2.0          # 4 kernels, 2 slots
    assert read["device_us_per_slot"] == pytest.approx(55 / 2)
    # busy: 10-55 and 60-65 us, 50 of 100
    assert read["device_idle"] == pytest.approx(50.0)
    b = 2 * (9 * (4 * 16 + 2 * 8) + 8 * 6 + 4 * 4 * 10 + 8 * 4 * 3)
    bound_s = 2 * b / 3.35e12
    assert read["arbitration_roofline"] == pytest.approx(
        100 * bound_s / 30e-6)


def test_readers_find_nothing_to_read():
    rec = dict(canned(), device=[])
    for name in NAMES:
        assert load_module("metrics", name).read(rec) is None


def test_breakdown_lists():
    rec = canned()
    assert profiling.busy_ns(rec) == 50 * US
    gaps = profiling.idle_gaps(rec)
    assert gaps[0] == ["aten::where", 35e-6]
    assert gaps[1] == ["aten::scatter_", 10e-6]
    assert gaps[2][1] == pytest.approx(5e-6)         # 55-60 us
    ops = profiling.top_device_ops(rec)
    assert sorted(ops[:2]) == [["elementwise_kernel", 20e-6],
                               ["void srpt_topk_kernel<8>(...)", 20e-6]]
    assert ops[2][1] == pytest.approx(10e-6) and len(ops) == 4


@pytest.mark.parametrize("shape,B,bytes_", [
    # PERF.md Sec. 6's bound column: one run's fused slot (6.6 MB), the
    # B = 12 batch (79 MB), the staged arbiter alone at 144 x 1024 (1.33
    # MB) and 1728 x 1024 (15.9 MB), the top-K alone (4.6 MB)
    (dict(H=144, cap=1024, U=144, ucap=512, M=8000, K=7), 1, 6_609_024),
    (dict(H=144, cap=1024, U=144, ucap=512, M=8000, K=7), 12, 79_308_288),
    (dict(H=144, cap=1024, U=0, ucap=0, M=0, K=0), 1, 1_328_256),
    (dict(H=1728, cap=1024, U=0, ucap=0, M=0, K=0), 1, 15_939_072),
])
def test_byte_counts(shape, B, bytes_):
    assert roofline.slot_bytes(B=B, **shape) == bytes_


def test_topk_bytes_and_bound():
    fused = dict(H=144, cap=1024, U=144, ucap=512, M=8000, K=7)
    rings = dict(fused, K=0)
    topk = roofline.slot_bytes(B=1, **fused) - roofline.slot_bytes(
        B=1, **rings)
    assert topk == 4 * 144 * 8000 + 8 * 144 * 7      # 4.6 MB
    # 0.00197 ms at 3.35 TB/s (PERF.md Sec. 6, row 3)
    assert roofline.slot_bytes(B=1, **fused) / 3.35e12 * 1e3 == \
        pytest.approx(0.00197, abs=5e-6)
