"""The hand-written CUDA kernels against their plain PyTorch versions
(the staged arbiter and top-K — its one-pass and rounds routines, by
their counter — the fused per-slot kernel at every stage subset and B in
{1, 4, 12}, the SSD chunk scan and flash attention, whose wrappers refuse
inputs that require grad), the lossy fabric on the card (each backend
against ``tests/golden/faults_enabled.json``, and a full-width fault
window with no host sync), and the host stage with telemetry (both
kernel backends against ``tests/golden/host_trace_enabled.json``, and
the ideal host with capture off against both fabric goldens), the
training step (the card's against the CPU's, no kernel launched) and the
data-parallel step on a NCCL world of one, and the MLA and MoE models at
reduced size (DeepSeek, Mixtral and Jamba prefill and decode against the
CPU, DeepSeek's serve).

These tests need a CUDA card and skip without one (marker ``gpu``); run
them there with ``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.
The module imports nothing of JAX, so it also runs where JAX is absent.
The input generators and cases are shared with ``test_torch_arbiter.py``
``test_torch_ssd.py`` and ``test_torch_attention.py``, which hold the
plain versions to the JAX package on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.arbiter import kernel
from repro_torch.kernels.arbiter.ref import (BIG, NEG, fused_slot_ref,
                                             priority_arbiter_ref,
                                             ring_insert_ref,
                                             srpt_topk_raw, srpt_topk_ref)

INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1


def _arb_inputs(H, cap, seed, *, n_prios=8, seq_hi=10_000, p_elig=0.3):
    """Random int32 rings in [0, BIG) with a bool eligibility mask; row 0
    is all-ineligible."""
    rng = np.random.default_rng(seed)
    prio = rng.integers(0, n_prios, (H, cap)).astype(np.int32)
    seq = rng.integers(0, seq_hi, (H, cap)).astype(np.int32)
    elig = rng.random((H, cap)) < p_elig
    elig[0] = False
    return prio, seq, elig


ARB_CASES = [
    # (H, cap, n_prios, seq_hi, p_elig)
    (8, 256, 8, 10_000, 0.3),
    (13, 100, 8, 10_000, 0.3),         # ragged
    (8, 1000, 8, 10_000, 0.5),         # ragged width
    (1, 1, 8, 10_000, 1.0),
    (6, 40, 2, 3, 0.7),                # dense (prio, seq) ties
    (5, 64, 1 << 30, 1 << 30, 0.5),    # full int32 range below BIG
    (4, 16, 8, 10_000, 0.0),           # every row empty
]


def _keys(H, M, seed, *, hi=1 << 28, p_pos=0.5, neg=False):
    """Random keys; ``neg`` puts NEG (``True``), or one of the given
    values (a tuple), in about 30% of the entries."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, (H, M)).astype(np.int32)
    keys = np.where(rng.random((H, M)) < p_pos, keys, 0).astype(np.int32)
    if neg:
        low = NEG
        if neg is not True:
            low = np.asarray(neg, np.int32)[rng.integers(0, len(neg), (H, M))]
        keys = np.where(rng.random((H, M)) < 0.3, low, keys).astype(np.int32)
    return keys


TOPK_CASES = [
    # (H, M, K, hi, p_pos, neg)
    (8, 512, 7, 1 << 28, 0.5, False),
    (13, 60, 5, 1 << 28, 0.5, False),   # ragged
    (4, 128, 1, 1 << 28, 0.5, False),
    (8, 300, 6, 3, 0.9, False),         # many tied keys
    (6, 3, 7, 100, 0.5, True),          # M < K with zeros and NEG keys
    # M < K with keys of NEG and below: the padding comes between them
    (6, 5, 7, 100, 0.5, (NEG, NEG - 1, INT_MIN + 1, INT_MIN)),
    (3, 1, 4, 100, 0.5, False),         # one column
    (5, 40, 4, 100, 0.0, False),        # all zero
    (4, 50, 3, (1 << 31) - 1, 1.0, False),  # full positive int32 range
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ARB_CASES + [(144, 1024, 8, 20_000, 0.5),
                                              (144, 512, 8, 20_000, 0.5),
                                              # rows off 16-byte boundaries
                                              (5, 1027, 8, 20_000, 0.5),
                                              # the B = 12 staged sweep's
                                              (1728, 1024, 8, 20_000, 0.5),
                                              (1728, 512, 8, 20_000, 0.5)])
def test_priority_arbiter_kernel_matches_plain(cuda, case):
    H, cap, n_prios, seq_hi, p_elig = case
    args = [torch.from_numpy(a).to(cuda) for a in
            _arb_inputs(H, cap, 11, n_prios=n_prios, seq_hi=seq_hi,
                        p_elig=p_elig)]
    before = kernel.priority_arbiter.launches
    got = kernel.priority_arbiter(*args)
    want = priority_arbiter_ref(*args)
    torch.cuda.synchronize()
    assert kernel.priority_arbiter.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _arb_edge_inputs(H, cap, seed, lead=()):
    """Rings (H >= 6 rows) that reach every branch of the row routine:
    negative values and eligible (BIG, BIG) entries everywhere; row 0
    empty; row 1 one winning (prio, seq) at columns of different threads,
    warps and units, its lowest column in a later warp; row 2 a winner
    whose seq is BIG (the plain version answers column 0); row 3 a winner
    with seq above BIG after a column of the same prio and seq above
    BIG; row 4 every entry (INT_MAX, INT_MAX); row 5 every entry of one
    prio with seq above BIG."""
    rng = np.random.default_rng(seed)
    shape = lead + (H, cap)
    prio = rng.integers(-3, 8, shape).astype(np.int64)
    seq = rng.integers(-50, 20_000, shape).astype(np.int64)
    elig = rng.random(shape) < 0.5
    prio[..., ::5], seq[..., ::5], elig[..., ::5] = BIG, BIG, True
    elig[..., 0, :] = False
    # the lowest (130) in a later warp than a higher one (600; 1025 for a
    # block of 256 threads) at 64 to 256 threads a row
    cols = [c for c in (130, 200, 600, 1025) if c < cap] + [cap - 1]
    prio[..., 1, cols], seq[..., 1, cols], elig[..., 1, cols] = -4, -60, True
    w = cap // 2
    prio[..., 2, :] = np.maximum(prio[..., 2, :], 0)
    prio[..., 2, w], seq[..., 2, w], elig[..., 2, w] = -5, BIG, True
    prio[..., 3, w], seq[..., 3, w], elig[..., 3, w] = -5, BIG + 7, True
    prio[..., 3, 0], seq[..., 3, 0], elig[..., 3, 0] = -5, BIG + 9, True
    prio[..., 4, :], seq[..., 4, :], elig[..., 4, :] = INT_MAX, INT_MAX, True
    prio[..., 5, :], elig[..., 5, :] = -5, True
    seq[..., 5, :] = BIG + 1 + rng.integers(0, 3, lead + (cap,))
    return prio.astype(np.int32), seq.astype(np.int32), elig


def _offset(a, ints, device):
    """a on the card, its data starting ``ints`` int32 past a 16-byte
    boundary (``ints`` bytes for a bool array, so that prio, seq and elig
    keep one offset in columns)."""
    t = torch.from_numpy(a).to(device)
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=device)
    out = buf[ints:ints + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == ints * t.element_size()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 1), (6, 33), (8, 1024), (7, 1027),
                                   (144, 512)])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 3, 3),
                                     (1, 0, 2)])
def test_priority_arbiter_kernel_edge_cases(cuda, shape, offsets):
    """``_arb_edge_inputs`` with prio, seq and elig starting 0-3 columns
    past their 16-byte boundaries, at one offset (the units path: each
    row then has a scalar head and tail) or at different ones (the scalar
    path), against the plain version."""
    H, cap = shape
    args = [_offset(a, o, cuda) for a, o in
            zip(_arb_edge_inputs(H, cap, cap), offsets)]
    got = kernel.priority_arbiter(*args)
    want = priority_arbiter_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(144, 1024), (1728, 512), (7, 1027)])
@pytest.mark.parametrize("layout", kernel.ARB_LAYOUTS + ((0, 1),))
def test_priority_arbiter_layouts_match_plain(cuda, shape, layout):
    """Every layout the staged kernel can be launched at (the ones
    chip_smoke.py times), on the main path's inputs and, but for PR 11's
    kernel (nt 0, timed only), on ``_arb_edge_inputs``."""
    from repro_torch.kernels.arbiter.build import load_library
    H, cap = shape
    nt, g = layout
    lib = load_library()
    cases = [_arb_inputs(H, cap, 4, n_prios=8, seq_hi=20_000, p_elig=0.5)]
    if nt:
        cases.append(_arb_edge_inputs(H, cap, 5))
    for case in cases:
        args = [torch.from_numpy(a).to(cuda) for a in case]
        bp = torch.empty(H, dtype=torch.int32, device=cuda)
        bi = torch.empty_like(bp)
        rc = lib.arbiter_priority_launch(
            *(t.data_ptr() for t in (*args, bp, bi)), H, cap, nt, g,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        want = priority_arbiter_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(bp, want[0]) and torch.equal(bi, want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES + [(144, 8000, 7, 1 << 30, 0.05,
                                                False)])
def test_srpt_topk_kernel_matches_plain(cuda, case):
    H, M, K, hi, p_pos, neg = case
    keys = torch.from_numpy(_keys(H, M, 5, hi=hi, p_pos=p_pos,
                                  neg=neg)).to(cuda)
    before = kernel.srpt_topk.launches
    got = kernel.srpt_topk(keys, K)
    want = srpt_topk_ref(keys, K)
    torch.cuda.synchronize()
    assert kernel.srpt_topk.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES)
def test_fused_slot_kernel_raw_topk_matches_plain(cuda, case):
    """The raw top-K, as the fused kernel returns it: ranks past a row's
    width and keys of NEG and below in the plain version's order."""
    H, M, K, hi, p_pos, neg = case
    keys = torch.from_numpy(_keys(H, M, 5, hi=hi, p_pos=p_pos,
                                  neg=neg)).to(cuda)
    got = kernel.fused_slot(keys=keys, K=K)
    want = srpt_topk_raw(keys, K)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [7, 8, 9, 32, 33, 64])
def test_srpt_topk_kernel_routes(cuda, K):
    """K up to 8 runs the one-pass routine, a larger K the rounds
    routine; the counter shows which, and both are exact on rows full of
    ties."""
    keys = torch.from_numpy(_keys(16, 1000, K, hi=6, p_pos=0.5)).to(cuda)
    n, rounds = kernel.srpt_topk.launches, kernel.srpt_topk.launches_rounds
    got = kernel.srpt_topk(keys, K)
    want = srpt_topk_ref(keys, K)
    torch.cuda.synchronize()
    assert (kernel.srpt_topk.launches - n,
            kernel.srpt_topk.launches_rounds - rounds) == (1, int(K > 8))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _boundary_ties(H, M, seed):
    """Grant-like keys whose 8 largest entries per row are equal and lie
    at columns read by different threads, warps and load batches of the
    one-pass top-K; only the tie rule orders them."""
    keys = _keys(H, M, seed, hi=1 << 20, p_pos=0.05)
    keys[:, [4 * 31 + 3, 4 * 32, 4 * 255 + 3, 4 * 256, 4 * 257 + 1, 4000,
             M - 5, M - 1]] = 1 << 21
    return keys


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_srpt_topk_kernel_ties_across_threads(cuda, offset):
    """At the main path's 144 x 8000, K = 7, with the ties above, and with
    the matrix starting ``offset`` ints past a 16-byte boundary (each row
    then has a scalar head and tail)."""
    H, M = 144, 8000
    buf = torch.zeros(H * M + 4, dtype=torch.int32, device=cuda)
    keys = buf[offset:offset + H * M].view(H, M)
    keys.copy_(torch.from_numpy(_boundary_ties(H, M, 9)))
    assert keys.data_ptr() % 16 == 4 * offset
    got = kernel.srpt_topk(keys, 7)
    want = srpt_topk_ref(keys, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_kernel_wrappers_reject_bad_inputs(cuda):
    p = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    e = torch.ones((4, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kernel.priority_arbiter(p.long(), p, e)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.priority_arbiter(p.t(), p.t(), e.t())
    with pytest.raises(ValueError, match="one shape"):
        kernel.priority_arbiter(p, p[:, :4].contiguous(), e)


STAGE_SUBSETS = ["down", "up", "topk", "down,up", "down,topk", "up,topk",
                 "down,up,topk"]


def _fused_inputs(stages, B, H, cap, U, ucap, M, K, seed, cuda):
    """Operands of the present stages, with a leading run axis when ``B``
    is given; ring row 0 of each run is all-ineligible, keys row 1 empty,
    and a quarter of the key entries are NEG (a top-K row past its
    width)."""
    lead = () if B is None else (B,)
    rng = np.random.default_rng(seed)

    def ring(R, C):
        prio = rng.integers(0, 8, lead + (R, C)).astype(np.int32)
        seq = rng.integers(0, 20_000, lead + (R, C)).astype(np.int32)
        elig = rng.random(lead + (R, C)) < 0.3
        elig[..., 0, :] = False
        return tuple(torch.from_numpy(a).to(cuda) for a in (prio, seq, elig))

    down = ring(H, cap) if "down" in stages else None
    up = ring(U, ucap) if "up" in stages else None
    keys = None
    if "topk" in stages:
        k = rng.integers(1, 1 << 30, lead + (H, M)).astype(np.int32)
        k = np.where(rng.random(lead + (H, M)) < 0.05, k, 0)
        k[..., 1, :] = 0
        k = np.where(rng.random(lead + (H, M)) < 0.25, NEG, k)
        keys = torch.from_numpy(k.astype(np.int32)).to(cuda)
    return down, up, keys


@pytest.mark.gpu
@pytest.mark.parametrize("stages", STAGE_SUBSETS)
@pytest.mark.parametrize("shape", [
    # (H, cap, U, ucap, M, K)
    (144, 1024, 144, 512, 8000, 7),    # the main path's shapes
    (13, 100, 9, 1, 37, 4),            # ragged; single-slot uplinks
    (8, 256, 8, 32, 3, 7),             # M < K; single-host racks
])
def test_fused_slot_kernel_matches_plain(cuda, stages, shape):
    H, cap, U, ucap, M, K = shape
    down, up, keys = _fused_inputs(stages, None, H, cap, U, ucap, M, K, 3,
                                   cuda)
    before = kernel.fused_slot.launches
    got = kernel.fused_slot(down=down, up=up, keys=keys, K=K)
    want = fused_slot_ref(down, up, keys, K)
    torch.cuda.synchronize()
    assert kernel.fused_slot.launches == before + 1
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("stages", STAGE_SUBSETS)
@pytest.mark.parametrize("B", [1, 4, 12])
def test_fused_slot_batch_kernel_matches_plain(cuda, stages, B):
    down, up, keys = _fused_inputs(stages, B, 144, 1024, 144, 512, 8000, 7,
                                   B, cuda)
    before = kernel.fused_slot_batch.launches
    got = kernel.fused_slot_batch(down=down, up=up, keys=keys, K=7)
    want = fused_slot_ref(down, up, keys, 7)
    torch.cuda.synchronize()
    assert kernel.fused_slot_batch.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_fused_slot_batch_kernel_empty_rings_main_shapes(cuda):
    """B = 12 at the main shapes with every ring row empty: only the
    top-K rows carry work, and the rings give (BIG, 0)."""
    down, up, keys = _fused_inputs("down,up,topk", 12, 144, 1024, 144, 512,
                                   8000, 7, 21, cuda)
    down, up = ((p, s, torch.zeros_like(e)) for p, s, e in (down, up))
    got = kernel.fused_slot_batch(down=down, up=up, keys=keys, K=7)
    want = fused_slot_ref(down, up, keys, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((got[1] == 0).all()) and bool((got[3] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [None, 4])
@pytest.mark.parametrize("K", [8, 9])
def test_fused_slot_kernel_routes(cuda, B, K):
    """The fused kernel takes the same route rule as ``srpt_topk``: a K
    past 8 runs its top-K rows on the rounds routine, counted."""
    fn = kernel.fused_slot if B is None else kernel.fused_slot_batch
    down, up, keys = _fused_inputs("down,up,topk", B, 16, 256, 16, 128, 1000,
                                   K, 17, cuda)
    n, rounds = fn.launches, fn.launches_rounds
    got = fn(down=down, up=up, keys=keys, K=K)
    want = fused_slot_ref(down, up, keys, K)
    torch.cuda.synchronize()
    assert (fn.launches - n, fn.launches_rounds - rounds) == (1, int(K > 8))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [None, 4, 12])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_fused_slot_kernel_ring_edge_cases(cuda, B, offset):
    """The fused kernels' ring rows run the staged kernel's row routine:
    ``_arb_edge_inputs`` in both ring stages (starting ``offset`` columns
    past their 16-byte boundaries) beside a top-K stage, at the main
    path's widths, single and batched."""
    lead = () if B is None else (B,)
    fn = kernel.fused_slot if B is None else kernel.fused_slot_batch
    down = [_offset(a, offset, cuda) for a in
            _arb_edge_inputs(144, 1024, 1, lead)]
    up = [_offset(a, offset, cuda) for a in
          _arb_edge_inputs(144, 512, 2, lead)]
    keys = torch.from_numpy(_keys(144 * (B or 1), 8000, 3, p_pos=0.05)
                            .reshape(lead + (144, 8000))).to(cuda)
    got = fn(down=tuple(down), up=tuple(up), keys=keys, K=7)
    want = fused_slot_ref(tuple(down), tuple(up), keys, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_fused_backend_launches_one_kernel_per_slot(cuda):
    """A small leaf-spine run on ``backend="fused"`` equals the staged
    ``"cuda"`` run and launches one fused kernel per slot, nothing
    staged, beside the fabric's three ring inserts a slot; a batch of
    three runs launches one ``fused_slot_batch``."""
    from repro_torch.core import (FabricConfig, SimConfig, SweepSpec,
                                  make_messages, run_sweep, simulate)
    tables = [make_messages("W2", n_hosts=8, load=0.7, n_messages=60,
                            slot_bytes=256, seed=s) for s in range(3)]
    kw = dict(protocol="homa", n_hosts=8, max_slots=300, ring_cap=64,
              fabric=FabricConfig(racks=4, up_cap=32), device="cuda")
    staged = simulate(SimConfig(**kw, backend="cuda"), tables[0])
    kernel.reset_launch_counts()
    fused = simulate(SimConfig(**kw, backend="fused"), tables[0])
    assert kernel.launch_counts() == {"priority_arbiter": 0, "srpt_topk": 0,
                                      "fused_slot": 300,
                                      "fused_slot_batch": 0,
                                      "ring_insert": 900}
    assert (fused.completion == staged.completion).all()
    assert (fused.q_max_bytes == staged.q_max_bytes).all()
    kernel.reset_launch_counts()
    swept = run_sweep(SimConfig(**kw, backend="fused"),
                      SweepSpec(tables=tables))
    assert kernel.launch_counts()["fused_slot_batch"] == 300
    assert (swept[0].completion == staged.completion).all()


@pytest.mark.gpu
def test_fused_wrappers_reject_bad_inputs(cuda):
    p = torch.zeros((2, 4, 8), dtype=torch.int32, device=cuda)
    e = torch.ones((2, 4, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="no stage"):
        kernel.fused_slot()
    with pytest.raises(ValueError, match="K must be >= 1"):
        kernel.fused_slot(keys=p[0], K=0)
    with pytest.raises(ValueError, match="2-D"):
        kernel.fused_slot(down=(p, p, e))
    with pytest.raises(ValueError, match="run axis"):
        kernel.fused_slot_batch(down=(p, p, e), keys=p[:1], K=2)
    with pytest.raises(TypeError):
        kernel.fused_slot_batch(down=(p.long(), p, e))


# ---------------------------------------------------------- ring insert ----

def _ring_inputs(device, B, R, cap, n, seed, *, p_valid=0.5, p_ok=0.8,
                 hot=None, full=()):
    """Random rings (B, R, cap) and items (B, n) on ``device`` as the
    fabric passes them: not-ok items on the sentinel row R, ``seq`` one
    slot number expanded; ``hot`` draws the rows from the first ``hot``
    only, ``full`` fills those rows in every run."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand((B, R, cap), generator=g) < p_valid
    valid[:, list(full)] = True
    ring = [torch.randint(0, 1 << 20, (B, R, cap), generator=g,
                          dtype=torch.int32) for _ in range(3)]
    row = torch.randint(0, hot or R, (B, n), generator=g, dtype=torch.int32)
    ok = torch.rand((B, n), generator=g) < p_ok
    row = torch.where(ok, row, R)
    msg, prio = (torch.randint(0, 8000, (B, n), generator=g,
                               dtype=torch.int32) for _ in range(2))
    seq = torch.tensor(777 + seed, dtype=torch.int32, device=device)
    return (*(t.to(device) for t in (*ring, valid, row, ok, msg, prio)),
            seq.expand(B, n))


RING_CASES = [
    # (B, R, cap, n, p_valid, p_ok, hot): the benchmark cells' shapes --
    # downlinks (144 x 1024) and uplinks (144 x 512) at B = 320 and 480,
    # 144 items a call -- at light and heavy fills, then edge shapes
    (320, 144, 1024, 144, 0.1, 0.2, None),
    (320, 144, 1024, 72, 0.6, 0.9, None),
    (320, 144, 512, 144, 0.3, 0.9, None),
    (480, 144, 1024, 144, 0.99, 1.0, None),
    (480, 144, 512, 144, 0.98, 1.0, 4),
    (1, 1, 1, 5, 0.0, 1.0, None),           # one slot, five items
    (2, 3, 100, 40, 0.5, 0.9, None),        # rows off 16-byte boundaries
    (3, 5, 16, 70, 0.3, 1.0, 2),            # n > cap
    (2, 4, 1500, 90, 0.99, 1.0, 1),         # three passes of a warp
    (2, 4, 64, 0, 0.5, 1.0, None),          # no items
    (4, 2, 2048, 600, 0.2, 0.95, 1),        # n above the block's threads
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_insert_kernel_matches_plain(cuda, case):
    B, R, cap, n, p_valid, p_ok, hot = case
    args = _ring_inputs(cuda, B, R, cap, n, 11, p_valid=p_valid, p_ok=p_ok,
                        hot=hot)
    want = ring_insert_ref(*args)
    got = kernel.ring_insert(*(t.clone() for t in args[:4]), *args[4:])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_ring_insert_full_rows_and_strided_items(cuda):
    """Full rows drop every item bound for them; items at any strides
    (a transposed ``msg``, an expanded ``seq``) are read where they lie."""
    args = list(_ring_inputs(cuda, 6, 9, 256, 50, 12, hot=4, full=(0, 2)))
    args[6] = args[6].t().contiguous().t()          # (B, n), strided
    assert not args[6].is_contiguous() and args[8].stride() == (0, 0)
    want = ring_insert_ref(*args)
    got = kernel.ring_insert(*(t.clone() for t in args[:4]), *args[4:])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[4].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_ring_insert_updates_in_place(cuda, backend):
    """On the kernel backends ``fabric.ring_insert`` returns its four ring
    arguments, updated where they lie, equal to the plain version's new
    tensors; the ``reference`` backend leaves its arguments as they
    were."""
    from repro_torch.core.fabric import ring_insert
    args = _ring_inputs(cuda, 320, 144, 512, 144, 13)
    before = [t.clone() for t in args[:4]]
    want = ring_insert(*before, *args[4:], backend="reference")
    assert all(torch.equal(b, a) for b, a in zip(before, args))
    kernel.reset_launch_counts()
    got = ring_insert(*args, backend=backend)
    torch.cuda.synchronize()
    assert kernel.launch_counts()["ring_insert"] == 1
    assert all(g is a for g, a in zip(got, args[:4]))
    assert all(g.data_ptr() == a.data_ptr()
               for g, a in zip(got[:4], args[:4]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_ring_insert_wrapper_rejects_bad_inputs(cuda):
    kernel.reset_launch_counts()
    args = _ring_inputs(cuda, 2, 4, 64, 8, 14)
    for k in (0, 3):                    # strided rings of the right shape
        bad = args[k].transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            kernel.ring_insert(*args[:k], bad, *args[k + 1:])
    for k in (0, 3, 4, 5, 8):
        wrong = args[k].long() if k != 5 else args[k].to(torch.uint8)
        with pytest.raises(TypeError):
            kernel.ring_insert(*args[:k], wrong, *args[k + 1:])
    with pytest.raises(ValueError, match="items"):
        kernel.ring_insert(*args[:4], args[4][:, :5], *args[5:])
    with pytest.raises(ValueError, match="3-D"):
        kernel.ring_insert(*(t[0] for t in args[:4]), *args[4:])
    assert kernel.ring_insert.launches == 0


# ------------------------------------------------------------------ SSD ----

SSD_CASES = [
    # (B, S, H, P, N, chunk): the JAX package's cases (test_kernels.py)
    (1, 32, 2, 8, 8, 8),
    (2, 64, 3, 8, 16, 16),
    (1, 48, 1, 16, 16, 16),   # pad path
    (2, 128, 4, 16, 32, 32),
]

SSD_KERNEL_CASES = SSD_CASES + [
    (1, 1024, 3, 64, 128, 256),   # the model's head and state widths
    (2, 350, 2, 80, 160, 100),    # P > 64, N > 128, chunk not /64; pad
    (1, 70, 1, 8, 16, 256),       # S < chunk: one chunk of 70
    (2, 40, 16, 8, 16, 8),        # the reduced model's SSD shape
    (4, 4096, 24, 64, 128, 256),  # the model's full-width prefill
    (2, 500, 3, 40, 128, 128),    # P < one panel; pad
]

# the cases the tensor-core route takes (kernel.takes_tensor_cores: chunk
# a multiple of 64 up to 256, P a multiple of 8 up to 64, N 128); every
# other case runs the CUDA-core kernels
SSD_TC_CASES = {(1, 1024, 3, 64, 128, 256), (4, 4096, 24, 64, 128, 256),
                (2, 500, 3, 40, 128, 128)}

# fp32 throughout; the chunked and the sequential forms differ only in
# summation order (~1e-4 absolute at |y| ~ 90, S = 1024-2048, measured
# on the CPU), so 1e-3 + 1e-3 * |ref| leaves a tenfold margin
SSD_ATOL = SSD_RTOL = 1e-3


def _ssd_inputs(B, S, H, P, N, seed, *, bf16=False):
    """Inputs as ``tests/test_kernels.py`` draws them: x normal, dt =
    softplus(normal), A = -exp(0.3 normal), B and C 0.5 normal; numpy
    f32 arrays, x/B/C rounded to bf16 values when ``bf16`` (returned as
    f32 arrays holding bf16 values)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, N))).astype(np.float32)
    if bf16:
        x, Bm, Cm = (torch.from_numpy(a).bfloat16().float().numpy()
                     for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm


def _ssd_tensors(arrays, device):
    """``_ssd_inputs`` as the kernel takes them: x/B/C bf16, dt/A f32."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(device) for a in arrays)
    return x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_KERNEL_CASES)
def test_ssd_kernel_matches_plain(cuda, case):
    """``ops.ssd`` (pad path included) launches the kernels once, on the
    route ``SSD_TC_CASES`` names (the counters say which), and matches
    ``ssd_ref``."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel, ops
    from repro_torch.kernels.ssd.ref import ssd_ref
    B, S, H, P, N, chunk = case
    args = _ssd_tensors(_ssd_inputs(B, S, H, P, N, 7, bf16=True), cuda)
    scan = ssd_kernel.ssd_scan
    before, before_tc = scan.launches, scan.launches_tc
    y, fs = ops.ssd(*args, chunk=chunk)
    yr, fr = ssd_ref(*args)
    torch.cuda.synchronize()
    assert (scan.launches - before, scan.launches_tc - before_tc) \
        == (1, int(case in SSD_TC_CASES))
    assert y.shape == yr.shape and fs.shape == fr.shape
    assert y.dtype == fs.dtype == torch.float32
    torch.testing.assert_close(y, yr, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(fs, fr, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 512, 2, 64, 128, 256),
                                  (2, 96, 2, 8, 16, 32)])
@pytest.mark.parametrize("dt_scale,a_mu", [(20.0, 2.0), (200.0, 4.0)])
def test_ssd_kernel_strong_decay(cuda, case, dt_scale, a_mu):
    """Large dt and strongly negative A (cums far below -1e3 within a
    chunk): exp(cums_i) and exp(cums_L - cums_l) underflow to 0 on both
    routes (the first case takes the tensor cores, the second the CUDA
    cores), nothing overflows, and the kernels match ``ssd_ref``."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_ref
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_tensors(_ssd_inputs(B, S, H, P, N, 3, bf16=True),
                                    cuda)
    dt, A = dt * dt_scale, A * float(np.exp(a_mu))
    assert float(torch.cumsum(dt[0, :chunk, 0] * A[0], 0)[-1]) < -1e3
    n_tc = ssd_kernel.ssd_scan.launches_tc
    y, fs = ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches_tc - n_tc == int(P == 64)
    assert torch.isfinite(y).all() and torch.isfinite(fs).all()
    torch.testing.assert_close(y, yr, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(fs, fr, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.gpu
def test_ssd_route_is_stable(cuda):
    """A tensor-core input takes the tensor cores on every call, with new
    data too, and gives the same bits for the same data; the same data
    with Bm starting 2 bytes past a 16-byte boundary takes the CUDA-core
    kernels by the rule, and every call matches ``ssd_ref``."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.ref import ssd_ref
    scan = ssd_kernel.ssd_scan
    first = None
    for seed in (1, 1, 2):
        args = _ssd_tensors(_ssd_inputs(1, 512, 3, 64, 128, seed, bf16=True),
                            cuda)
        assert ssd_kernel.takes_tensor_cores(args[0], args[3], args[4], 256)
        n, n_tc = scan.launches, scan.launches_tc
        y, fs = scan(*args, chunk=256)
        torch.cuda.synchronize()
        assert (scan.launches - n, scan.launches_tc - n_tc) == (1, 1)
        yr, fr = ssd_ref(*args)
        torch.testing.assert_close(y, yr, atol=SSD_ATOL, rtol=SSD_RTOL)
        torch.testing.assert_close(fs, fr, atol=SSD_ATOL, rtol=SSD_RTOL)
        if first is None:
            first = (y, fs)
        elif seed == 1:
            assert torch.equal(y, first[0]) and torch.equal(fs, first[1])
    x, dt, A, Bm, Cm = args
    Bm = _misaligned(Bm)
    assert Bm.data_ptr() % 16 == 2
    assert not ssd_kernel.takes_tensor_cores(x, Bm, Cm, 256)
    n, n_tc = scan.launches, scan.launches_tc
    y2, fs2 = scan(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert (scan.launches - n, scan.launches_tc - n_tc) == (1, 0)
    torch.testing.assert_close(y2, yr, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(fs2, fr, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.gpu
def test_ssd_kernel_rejects_bad_inputs(cuda):
    from repro_torch.kernels.ssd.kernel import ssd_scan
    x, dt, A, Bm, Cm = _ssd_tensors(_ssd_inputs(1, 32, 2, 8, 8, 0), cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=5)
    with pytest.raises(TypeError, match="x must be"):
        ssd_scan(x.float(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(TypeError, match="dt must be"):
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_scan(x, dt, A[:1], Bm, Cm, chunk=8)


@pytest.mark.gpu
def test_ssd_kernel_refuses_inputs_that_require_grad(cuda):
    """The kernel has no backward: with grad enabled an input that
    requires grad raises, naming the plain path; without grad it runs."""
    from repro_torch.kernels.ssd.kernel import ssd_scan
    args = list(_ssd_tensors(_ssd_inputs(1, 32, 2, 8, 8, 0), cuda))
    for i in range(len(args)):
        grad = [a.detach().requires_grad_(j == i) for j, a in
                enumerate(args)]
        with pytest.raises(RuntimeError, match="use_kernel=False"):
            ssd_scan(*grad, chunk=8)
        with torch.no_grad():
            y, _ = ssd_scan(*grad, chunk=8)
        assert not y.requires_grad


@pytest.mark.gpu
def test_mamba_block_runs_the_kernel_on_a_card(cuda):
    """On a CUDA tensor ``mamba_block`` launches the SSD kernel once by
    default and never with ``use_kernel=False``; the two agree."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.models import model as M, ssm
    from repro_torch.models.params import init_params
    cfg = reduced_config("mamba2-130m")
    params = init_params(M.model_defs(cfg),
                         torch.Generator(cuda).manual_seed(0), cuda)
    p = {k: v[0] for k, v in params["blocks"]["s0"]["mixer"].items()}
    x = torch.randn((2, 37, cfg.d_model), generator=torch.Generator(cuda)
                    .manual_seed(1), device=cuda).bfloat16()
    before = ssd_kernel.ssd_scan.launches
    out, (fs, tail) = ssm.mamba_block(cfg, p, x)
    assert ssd_kernel.ssd_scan.launches == before + 1
    out_p, (fs_p, tail_p) = ssm.mamba_block(cfg, p, x, use_kernel=False)
    assert ssd_kernel.ssd_scan.launches == before + 1
    torch.testing.assert_close(fs, fs_p, atol=SSD_ATOL, rtol=SSD_RTOL)
    assert torch.equal(tail, tail_p)
    # bf16 output: one-ulp flips of bf16 roundings between the two paths
    torch.testing.assert_close(out.float(), out_p.float(), atol=2e-2,
                               rtol=2e-2)


# ------------------------------------------------------------ attention ----

ATTN_CASES = [
    # (B, Sq, Skv, H, KV, d, causal, window, dtype): the JAX package's
    # cases (test_kernels.py)
    (1, 64, 64, 4, 4, 32, True, None, "f32"),
    (2, 96, 96, 4, 2, 16, True, None, "f32"),
    (1, 128, 128, 8, 1, 64, True, 32, "f32"),
    (2, 64, 64, 2, 2, 32, False, None, "f32"),
    (1, 80, 80, 4, 4, 32, True, None, "bf16"),
    (1, 33, 33, 2, 2, 8, True, None, "f32"),     # ragged block
]

ATTN_KERNEL_CASES = ATTN_CASES + [
    (2, 300, 300, 6, 2, 128, True, None, "bf16"),   # the model's head dim
    (1, 130, 130, 3, 1, 128, False, None, "f32"),   # KV = 1, d 128, fp32
    (1, 5, 5, 4, 2, 128, True, None, "bf16"),       # Sq < 8: the pad path
    (1, 200, 200, 2, 2, 13, True, 5, "f32"),        # d not /4: scalar loads
    (2, 100, 40, 4, 2, 24, False, 10, "bf16"),      # rows q >= 49 have no
    (1, 100, 40, 2, 1, 16, True, 10, "f32"),        # valid key: uniform
]

# the JAX package's own tolerances for kernel vs oracle
# (tests/test_kernels.py): fp32 throughout, so only the order of the fp32
# sums differs
ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def _attn_inputs(B, Sq, Skv, H, KV, d, seed):
    """Standard normal q (B,Sq,H,d), k and v (B,Skv,KV,d) as numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32))


def _attn_tensors(arrays, dtype, device):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype])
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_KERNEL_CASES)
def test_attention_kernel_matches_plain(cuda, case):
    """``ops.attention`` (pad path included) launches the kernel once and
    matches ``attention_ref`` on the same padded call."""
    from repro_torch.kernels.attention import kernel as attn_kernel, ops
    from repro_torch.kernels.attention.ref import attention_ref
    B, Sq, Skv, H, KV, d, causal, window, dtype = case
    q, k, v = _attn_tensors(_attn_inputs(B, Sq, Skv, H, KV, d, 42), dtype,
                            cuda)
    before = attn_kernel.flash_attention.launches
    out = ops.attention(q, k, v, causal=causal, window=window, block_q=32,
                        block_kv=32)
    torch.cuda.synchronize()
    assert attn_kernel.flash_attention.launches == before + 1
    ref = ops.attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                        window=window, block_q=32, block_kv=32)
    assert out.dtype == q.dtype and out.shape == ref.shape
    tol = ATTN_TOL[dtype]

    def which_side(msg):
        return msg + "\n" + _attention_mismatch_report(
            out, ref, (q, k, v), dict(causal=causal, window=window), tol)
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=tol,
                               rtol=tol, msg=which_side)


def _attention_mismatch_report(out, ref, qkv, mask, tol):
    """Which side moved when the kernel's output ``out`` and the CPU fp32
    reference ``ref`` disagree (ROADMAP C4): each against one float64
    ``attention_ref`` of the same inputs, where each side's bad elements
    are (batch, row, head), whether a second kernel call and a second CPU
    reference give the same bits, and the CPU's matmul settings."""
    from repro_torch.kernels.attention import ops
    q, k, v = qkv
    f64 = ops.attention(*(t.cpu().double() for t in qkv), **mask,
                        block_q=32, block_kv=32)
    again = ops.attention(q, k, v, **mask, block_q=32, block_kv=32).cpu()
    ref_again = ops.attention(*(t.cpu() for t in qkv), **mask, block_q=32,
                              block_kv=32)
    lines = [f"float64 oracle {tuple(f64.shape)}; tolerance {tol} + {tol} "
             f"|want|; torch {torch.__version__}, fp32 matmul precision "
             f"{torch.get_float32_matmul_precision()}, CPU threads "
             f"{torch.get_num_threads()}, q/k/v 16-byte offsets "
             f"{[t.data_ptr() % 16 for t in qkv]}"]
    for side, got in (("kernel", out.cpu()), ("CPU fp32 reference", ref)):
        d = (got.double() - f64).abs()
        bad = (d > tol + tol * f64.abs()).nonzero().tolist()
        lines.append(f"{side} vs float64: max abs {float(d.max()):.3e}, "
                     f"{len(bad)} elements outside the tolerance at (batch, "
                     f"row, head) {sorted({tuple(b[:3]) for b in bad})[:20]}")
    lines.append(f"a second kernel call bit-identical: "
                 f"{torch.equal(again, out.cpu())}; a second CPU reference "
                 f"bit-identical: {torch.equal(ref_again, ref)}")
    return "\n".join(lines)


@pytest.mark.gpu
def test_attention_kernel_repeats_exactly(cuda):
    """The CUDA-core kernel on ``ATTN_CASES[0]`` (1 x 64 x 64, 4 heads, d
    32, causal, fp32, through ``ops.attention`` with 32-row blocks) 200
    times: every output within 2e-5 of ``attention_ref`` in float64 (on
    the card) and bit-identical to the first (a race between its
    barriers would show as an occasional mismatch)."""
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import attention_ref
    B, Sq, Skv, H, KV, d, causal, window, dtype = ATTN_CASES[0]
    q, k, v = _attn_tensors(_attn_inputs(B, Sq, Skv, H, KV, d, 42), dtype,
                            cuda)
    ref = attention_ref(q.double(), k.double(), v.double(), causal=causal,
                        window=window)
    first = None
    for _ in range(200):
        out = ops.attention(q, k, v, causal=causal, window=window,
                            block_q=32, block_kv=32)
        torch.testing.assert_close(out.double(), ref, atol=2e-5, rtol=2e-5)
        if first is None:
            first = out
        assert torch.equal(out, first)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1, 37, 100])
def test_attention_kernel_kv_len(cuda, kv_len):
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref
    q, k, v = _attn_tensors(_attn_inputs(2, 100, 100, 4, 2, 64, 3), "f32",
                            cuda)
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        ref = attention_ref(q, k, v, causal=causal, kv_len=kv_len)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_attention_kernel_rows_without_valid_key(cuda, causal):
    """Window 2, kv_len 8 over 200 keys: queries 9.. see no valid key and
    average v over all 200, as ``attention_ref`` does — the kernel goes on
    past the tiles that hold valid keys while such a row remains."""
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref
    q, k, v = _attn_tensors(_attn_inputs(2, 200, 200, 4, 2, 32, 4), "f32",
                            cuda)
    out = flash_attention(q, k, v, causal=causal, window=2, kv_len=8)
    ref = attention_ref(q, k, v, causal=causal, window=2, kv_len=8)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_attention_kernel_refuses_inputs_that_require_grad(cuda, dtype):
    """Neither kernel has a backward: with grad enabled an input that
    requires grad raises, naming the plain path; without grad it runs."""
    from repro_torch.kernels.attention.kernel import flash_attention
    qkv = _attn_tensors(_attn_inputs(1, 64, 64, 2, 2, 64, 3), dtype, cuda)
    for i in range(3):
        grad = [t.detach().requires_grad_(j == i) for j, t in enumerate(qkv)]
        with pytest.raises(RuntimeError, match="use_kernel=False"):
            flash_attention(*grad, causal=True)
        with torch.no_grad():
            assert not flash_attention(*grad, causal=True).requires_grad


@pytest.mark.gpu
def test_attention_kernel_rejects_bad_inputs(cuda):
    from repro_torch.kernels.attention.kernel import flash_attention
    q, k, v = _attn_tensors(_attn_inputs(1, 16, 16, 2, 1, 264, 0), "bf16",
                            cuda)
    with pytest.raises(ValueError, match="at most 256"):
        flash_attention(q, k, v)
    q, k, v = _attn_tensors(_attn_inputs(1, 16, 16, 2, 1, 32, 0), "bf16",
                            cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="do not agree"):
        flash_attention(q, k[..., :16].contiguous(), v)


@pytest.mark.gpu
def test_self_attention_runs_the_kernel_on_a_card(cuda):
    """On a CUDA tensor ``self_attention`` launches the kernel once by
    default and never with ``use_kernel=False``; the two agree within the
    bf16 rounding of p that only the plain path takes."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.models import layers, model as M
    from repro_torch.models.params import init_params
    cfg = reduced_config("llama3.2-3b")
    params = init_params(M.model_defs(cfg),
                         torch.Generator(cuda).manual_seed(0), cuda)
    p = {k: v[0] for k, v in params["blocks"]["s0"]["mixer"].items()}
    x = torch.randn((2, 37, cfg.d_model), generator=torch.Generator(cuda)
                    .manual_seed(1), device=cuda).bfloat16()
    pos = torch.arange(37, device=cuda)
    before = attn_kernel.flash_attention.launches
    out, (k, v) = layers.self_attention(cfg, p, x, pos)
    assert attn_kernel.flash_attention.launches == before + 1
    out_p, (k_p, v_p) = layers.self_attention(cfg, p, x, pos,
                                              use_kernel=False)
    assert attn_kernel.flash_attention.launches == before + 1
    assert torch.equal(k, k_p) and torch.equal(v, v_p)
    torch.testing.assert_close(out.float(), out_p.float(), atol=2e-2,
                               rtol=2e-2)


# -------------------------------------------------- MLA and MoE models ----

def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype or tree.dtype)


def _normwise(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_attn", [
    ("deepseek-v2-lite-16b", 3), ("mixtral-8x7b", 2),
    ("jamba-1.5-large-398b", 0)])
def test_reduced_moe_archs_on_the_card_match_the_cpu(cuda, arch, n_attn):
    """Reduced DeepSeek (MLA + MoE), Mixtral (windowed GQA + MoE) and
    Jamba (SSM + attention + MoE) in fp32: the card's prefill (one
    attention launch per attention layer, on the CUDA-core kernel; Jamba
    on the plain path, since the SSD kernel takes bf16 only) and a decode
    step from its caches against the CPU's, normwise within 1e-3 (fp32
    sum order; the CPU measured Jamba's 16 layers moving fp32 noise to
    4e-4 of the caches against JAX, tests/test_torch_archs.py)."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.ssd.kernel import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = reduced_config(arch)
    params = _to(init_params(M.model_defs(cfg),
                             torch.Generator().manual_seed(0), "cpu"),
                 "cpu", torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(1))
    nxt = tok[:, -1:]
    use_kernel = None if n_attn else False
    n, n_ssd = flash_attention.launches, ssd_scan.launches
    lg, caches = M.forward_prefill(cfg, _to(params, cuda),
                                   tok[:, :-1].to(cuda),
                                   use_kernel=use_kernel)
    torch.cuda.synchronize()
    assert flash_attention.launches - n == n_attn
    assert ssd_scan.launches == n_ssd
    lc, caches_c = M.forward_prefill(cfg, params, tok[:, :-1])
    V = cfg.vocab_size
    assert _normwise(lg[:, :V], lc[:, :V]) <= 1e-3
    step, _ = M.forward_decode(cfg, _to(params, cuda), nxt.to(cuda), 39,
                               caches)
    step_c, _ = M.forward_decode(cfg, params, nxt, 39, caches_c)
    assert _normwise(step[:, :V], step_c[:, :V]) <= 1e-3


@pytest.mark.gpu
def test_jamba_runs_both_kernels_on_the_card(cuda):
    """Reduced Jamba in bf16 on the card: its prefill launches the
    attention kernel for each of its 2 attention layers and the SSD scan
    for each of its 14 SSM layers, and a decode step follows from its
    caches. Against the card's plain path end to end, within chip_smoke's
    MODEL_TOL logits bound (0.35: the SSD kernel's fp32 sums and the
    attention kernel's fp32 p.V flip bf16 roundings that 16 layers and the
    MoE routing carry on; gross faults only)."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.ssd.kernel import ssd_scan
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = reduced_config("jamba-1.5-large-398b")
    params = init_params(M.model_defs(cfg),
                         torch.Generator(cuda).manual_seed(4), cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(5))
    n, n_ssd = flash_attention.launches, ssd_scan.launches
    lk, caches = M.forward_prefill(cfg, params, tok[:, :-1])
    torch.cuda.synchronize()
    assert (flash_attention.launches - n, ssd_scan.launches - n_ssd) \
        == (2, 14)
    lp, _ = M.forward_prefill(cfg, params, tok[:, :-1], use_kernel=False)
    V = cfg.vocab_size
    assert bool(torch.isfinite(lk).all())
    rel = float((lk[:, :V] - lp[:, :V]).float().norm()
                / lp[:, :V].float().norm())
    assert rel <= _chip_smoke().MODEL_TOL["logits"]
    step, _ = M.forward_decode(cfg, params, tok[:, -1:], 39, caches)
    assert bool(torch.isfinite(step).all())


@pytest.mark.gpu
def test_deepseek_mla_prefill_runs_the_tensor_cores(cuda):
    """Reduced DeepSeek in bf16: each MLA layer's prefill attention (q/k
    24 wide, v 16) is one tensor-core launch, and the kernel path stays
    within the bf16 rounding of p of the plain path."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = reduced_config("deepseek-v2-lite-16b")
    params = init_params(M.model_defs(cfg),
                         torch.Generator(cuda).manual_seed(2), cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(3))
    n, n_tc = flash_attention.launches, flash_attention.launches_tc
    lk, _ = M.forward_prefill(cfg, params, tok)
    torch.cuda.synchronize()
    assert (flash_attention.launches - n,
            flash_attention.launches_tc - n_tc) == (3, 3)
    lp, _ = M.forward_prefill(cfg, params, tok, use_kernel=False)
    assert flash_attention.launches - n == 3
    V = cfg.vocab_size
    assert _normwise(lk[:, :V], lp[:, :V]) <= 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n_prefill,n_decode", [
    ("whisper-small", 6, 2), ("llama-3.2-vision-90b", 10, 2)])
def test_reduced_encdec_and_cross_archs_on_the_card_match_the_cpu(
        cuda, arch, n_prefill, n_decode):
    """Reduced Whisper (2 encoder layers, 2 decoder layers each with a
    cross-attention) and Llama-3.2-Vision (layers 4 and 9 cross) in
    fp32: the card's prefill (one launch per encoder layer, self layer
    and cross-attention) and a decode step from its caches (one launch
    per cross-attention) against the CPU's, normwise within 1e-3 (fp32
    sum order)."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = reduced_config(arch)
    params = _to(init_params(M.model_defs(cfg),
                             torch.Generator().manual_seed(0), "cpu"),
                 "cpu", torch.float32)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 21), generator=gen)
    n = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.num_image_tokens
    emb = torch.randn((2, n, cfg.d_model), generator=gen)
    key = "enc_embeds" if cfg.is_encoder_decoder else "img_embeds"
    nxt = tok[:, -1:]
    before = flash_attention.launches
    lg, caches = M.forward_prefill(cfg, _to(params, cuda),
                                   tok[:, :-1].to(cuda),
                                   **{key: emb.to(cuda)})
    torch.cuda.synchronize()
    assert flash_attention.launches - before == n_prefill
    lc, caches_c = M.forward_prefill(cfg, params, tok[:, :-1],
                                     **{key: emb})
    V = cfg.vocab_size
    assert _normwise(lg[:, :V], lc[:, :V]) <= 1e-3
    before = flash_attention.launches
    step, deltas = M.forward_decode(cfg, _to(params, cuda), nxt.to(cuda),
                                    20, caches)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == n_decode
    step_c, deltas_c = M.forward_decode(cfg, params, nxt, 20, caches_c)
    assert _normwise(step[:, :V], step_c[:, :V]) <= 1e-3
    assert {k: set(v) for k, v in deltas["blocks"].items()} == \
        {k: set(v) for k, v in deltas_c["blocks"].items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-90b"])
def test_encdec_and_cross_prefill_run_the_tensor_cores(cuda, arch):
    """The same reduced models in bf16 on the card: every attention call
    of the prefill is a tensor-core launch, and the kernel path stays
    within tests/test_torch_encdec.py's KERNEL_FRAC (rel RMS, last-token
    logits) of the card's plain path."""
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    kernel_frac = {"whisper-small": 4e-2, "llama-3.2-vision-90b": 7e-2}
    cfg = reduced_config(arch)
    gen = torch.Generator(cuda).manual_seed(2)
    params = init_params(M.model_defs(cfg), gen, cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                        generator=gen)
    n = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.num_image_tokens
    kw = {"enc_embeds" if cfg.is_encoder_decoder else "img_embeds":
          torch.randn((2, n, cfg.d_model), device=cuda, generator=gen)
          .bfloat16()}
    calls = (cfg.encoder_layers + 2 * cfg.num_layers
             if cfg.is_encoder_decoder else cfg.num_layers)
    c, c_tc = flash_attention.launches, flash_attention.launches_tc
    lk, _ = M.forward_prefill(cfg, params, tok, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches - c,
            flash_attention.launches_tc - c_tc) == (calls, calls)
    lp, _ = M.forward_prefill(cfg, params, tok, use_kernel=False, **kw)
    assert flash_attention.launches - c == calls
    V = cfg.vocab_size
    rel = float((lk[:, :V] - lp[:, :V]).float().norm()
                / lp[:, :V].float().norm())
    assert rel <= kernel_frac[arch]


@pytest.mark.gpu
def test_deepseek_serve_on_the_card(cuda):
    """``serve --arch deepseek-v2-lite-16b --smoke`` on the card gives the
    JAX package's statistics (``chip_smoke.SERVE_EXPECTED``)."""
    from repro_torch.launch import serve
    smoke = _chip_smoke()
    res = serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                      *smoke.SERVE_ARGV, "--device", "cuda"])
    assert {k: res[k] for k in smoke.SERVE_EXPECTED} == smoke.SERVE_EXPECTED


# ----------------------------------------------- tensor-core attention ----

ATTN_TC_CASES = [
    # (B, Sq, Skv, H, KV, d, dv, causal, window, kv_len): every one runs
    # the tensor-core kernel (bf16, d and dv multiples of 8)
    (1, 64, 64, 2, 2, 64, 64, False, None, None),       # one tile
    (2, 200, 200, 6, 2, 128, 128, True, None, None),    # ragged, group 3
    (1, 333, 333, 8, 1, 128, 128, True, None, None),    # KV = 1, group 8
    (2, 150, 300, 4, 4, 64, 64, False, None, None),     # group 1, Sq < Skv
    (1, 300, 40, 4, 2, 128, 128, False, None, None),    # Skv < one tile
    (1, 257, 257, 6, 2, 128, 128, True, 100, None),     # window
    (2, 300, 300, 4, 2, 64, 64, False, None, 170),      # kv_len
    (1, 260, 260, 3, 1, 128, 128, True, None, 37),      # causal + kv_len
    (2, 200, 200, 4, 2, 64, 64, False, 2, 8),           # rows 9.. have no
    (1, 200, 200, 4, 2, 128, 128, True, 2, 8),          # valid key
    (1, 5, 5, 4, 2, 128, 128, True, None, None),        # Sq < 8
    (1, 100, 100, 4, 2, 32, 32, True, None, None),      # d < one panel
    (1, 130, 130, 2, 1, 96, 96, True, None, None),      # d 1.5 panels
    (1, 140, 140, 4, 2, 128, 64, True, None, None),     # dv < d
    (1, 140, 140, 4, 2, 64, 128, False, 50, None),      # dv > d
    (2, 300, 300, 4, 4, 192, 128, True, None, None),    # MLA: 3 q/k panels
    (1, 5, 5, 4, 4, 192, 128, True, None, None),        # Sq < 8 at d 192
    (1, 260, 260, 4, 4, 192, 128, True, None, 150),     # kv_len < Skv
    (1, 200, 200, 4, 2, 192, 128, True, 2, 8),          # starved rows
    (1, 257, 257, 4, 2, 192, 128, False, 100, None),    # window, non-causal
    (1, 140, 140, 4, 2, 192, 64, True, None, None),     # <3, 1>
    (1, 140, 140, 4, 2, 160, 128, True, None, None),    # 2.5 q/k panels
    # the wide design (dv 136..160: 112-key tiles, a 160-column p.V)
    (2, 200, 200, 8, 2, 160, 160, True, None, None),    # StableLM, ragged
    (1, 333, 333, 8, 2, 160, 160, True, None, None),    # past 3 key tiles
    (1, 257, 257, 8, 2, 160, 160, True, 100, None),     # window
    (2, 300, 300, 4, 1, 160, 160, False, None, 170),    # kv_len, GQA 4
    (1, 260, 260, 4, 1, 160, 160, True, None, 37),      # causal + kv_len
    (1, 200, 200, 4, 2, 160, 160, True, 2, 8),          # starved rows
    (1, 5, 5, 4, 2, 160, 160, True, None, None),        # Sq < 8
    (1, 300, 40, 4, 2, 160, 160, False, None, None),    # Skv < one tile
    (2, 150, 300, 8, 2, 160, 160, False, 50, None),     # Sq < Skv, window
    (1, 140, 140, 4, 2, 192, 160, True, None, None),    # d 192: 12 k steps
    (1, 140, 140, 4, 2, 136, 136, True, None, None),    # d 136: 10 k steps
    (1, 140, 140, 4, 2, 128, 144, True, None, None),    # d 128: 8 k steps
    (1, 140, 140, 4, 2, 64, 160, False, None, None),    # d 64: a q/k panel
                                                        # wholly past d
    # the encoder-decoder's and the cross-attention model's non-causal
    # calls: Skv 1500 (Whisper's frames) against 448 decoder tokens and
    # against itself, and 6400 image tokens with 64 heads over 8
    (2, 448, 1500, 12, 12, 64, 64, False, None, None),
    (1, 1500, 1500, 12, 12, 64, 64, False, None, None),
    (1, 512, 6400, 64, 8, 128, 128, False, None, None),
]

ATTN_WIDE_CASES = [
    # (B, Sq, Skv, H, KV, d, dv, causal, window, kv_len, dtype): heads the
    # tensor-core kernel does not take (dv > 160, d > 192, or fp32), on
    # the CUDA-core kernel up to 256
    (2, 200, 200, 8, 2, 160, 168, True, None, None, "bf16"),  # dv past 160
    (2, 200, 200, 8, 2, 160, 160, True, None, None, "f32"),   # StableLM fp32
    (1, 130, 130, 4, 1, 256, 256, True, None, None, "bf16"),
    (1, 150, 150, 4, 2, 192, 256, False, 40, None, "bf16"),
    (1, 5, 5, 4, 4, 192, 128, True, None, None, "f32"),       # Sq < 8
    (1, 260, 260, 4, 4, 192, 128, True, None, 150, "f32"),    # MLA, fp32
    (1, 100, 100, 2, 2, 256, 256, True, 2, 8, "f32"),         # starved rows
    (1, 90, 90, 2, 1, 250, 136, True, None, None, "bf16"),    # d not /8
]


def _chip_smoke():
    """``chip_smoke.py``'s module (its tolerances), loaded by path."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tc_inputs(B, Sq, Skv, H, KV, d, dv, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16)
            for shape in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, dv))]


def _assert_attention_close(out, ref):
    """Elementwise within ATTN_TOL and in relative RMS (whole output and
    worst row) within chip_smoke's ATTN_RMS_TOL, bf16."""
    tol = ATTN_TOL["bf16"]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    rtol = _chip_smoke().ATTN_RMS_TOL["bfloat16"]
    diff = out.float() - ref.float()
    assert float(diff.norm() / ref.float().norm()) <= rtol["rms"]
    rows = diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)
    assert float(rows.max()) <= rtol["row"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_TC_CASES)
def test_attention_tc_kernel_matches_plain(cuda, case):
    """The tensor-core kernel, called directly (ragged tails reach it
    unpadded), against ``attention_ref``; one launch, counted in both
    counters."""
    from repro_torch.kernels.attention.kernel import flash_attention
    from repro_torch.kernels.attention.ref import attention_ref
    B, Sq, Skv, H, KV, d, dv, causal, window, kv_len = case
    q, k, v = _tc_inputs(B, Sq, Skv, H, KV, d, dv, 21, cuda)
    n, n_tc = flash_attention.launches, flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, window=window,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.launches_tc) \
        == (n + 1, n_tc + 1)
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        kv_len=kv_len)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _assert_attention_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_WIDE_CASES)
def test_attention_wide_heads_on_cuda_cores(cuda, case):
    """Head widths past the tensor-core kernel's (dv above 160, d up to
    256) and fp32 at MLA's (192, 128) and StableLM's (160, 160) run the
    CUDA-core kernel — one launch, none on the tensor cores — and match
    ``attention_ref``."""
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      takes_tensor_cores)
    from repro_torch.kernels.attention.ref import attention_ref
    B, Sq, Skv, H, KV, d, dv, causal, window, kv_len, dtype = case
    q, k, v = _tc_inputs(B, Sq, Skv, H, KV, d, dv, 23, cuda)
    if dtype == "f32":
        q, k, v = q.float(), k.float(), v.float()
    assert not takes_tensor_cores(q, k, v)
    n, n_tc = flash_attention.launches, flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=causal, window=window,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert (flash_attention.launches - n,
            flash_attention.launches_tc - n_tc) == (1, 0)
    ref = attention_ref(q, k, v, causal=causal, window=window,
                        kv_len=kv_len)
    assert out.dtype == q.dtype and out.shape == ref.shape
    if dtype == "f32":
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        _assert_attention_close(out, ref)


def _misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["bf16 d 128", "bf16 d 64", "fp32",
                                   "bf16 d 20", "bf16 dv 12",
                                   "bf16 misaligned", "bf16 d 192 dv 128",
                                   "bf16 d 160 dv 160", "fp32 d 160 dv 160",
                                   "bf16 d 160 dv 168", "bf16 d 200"])
def test_attention_routing_rule(cuda, route):
    """``takes_tensor_cores`` decides, and the counters show it: bf16 with
    d and dv multiples of 8 on 16-byte boundaries runs the tensor-core
    kernel, anything else the CUDA-core kernel; both match
    ``attention_ref``."""
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      takes_tensor_cores)
    from repro_torch.kernels.attention.ref import attention_ref
    d, dv = {"bf16 d 64": (64, 64), "bf16 d 20": (20, 20),
             "bf16 dv 12": (64, 12), "bf16 d 192 dv 128": (192, 128),
             "bf16 d 160 dv 160": (160, 160),
             "fp32 d 160 dv 160": (160, 160),
             "bf16 d 160 dv 168": (160, 168),
             "bf16 d 200": (200, 128)}.get(route, (128, 128))
    q, k, v = _tc_inputs(2, 70, 70, 4, 2, d, dv, 5, cuda)
    if route.startswith("fp32"):
        q, k, v = q.float(), k.float(), v.float()
    if route == "bf16 misaligned":
        q = _misaligned(q)
        assert q.data_ptr() % 16 == 2
    tc = route in ("bf16 d 128", "bf16 d 64", "bf16 d 192 dv 128",
                   "bf16 d 160 dv 160")
    assert takes_tensor_cores(q, k, v) == tc
    n, n_tc = flash_attention.launches, flash_attention.launches_tc
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (flash_attention.launches - n,
            flash_attention.launches_tc - n_tc) == (1, int(tc))
    ref = attention_ref(q, k, v, causal=True)
    if route.startswith("fp32"):
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        _assert_attention_close(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32", "bf16 d 160"])
def test_attention_kernels_are_deterministic(cuda, dtype):
    """Two calls on the same inputs give bit-identical outputs (no
    atomics, a fixed order of sums) on either kernel and either design
    of the tensor-core one."""
    from repro_torch.kernels.attention.kernel import flash_attention
    d = 160 if dtype.endswith("160") else 128
    q, k, v = _tc_inputs(2, 300, 300, 6, 2, d, d, 8, cuda)
    if dtype == "f32":
        q, k, v = q.float(), k.float(), v.float()
    a = flash_attention(q, k, v, causal=True, window=90)
    b = flash_attention(q, k, v, causal=True, window=90)
    assert torch.equal(a, b)


# ------------------------------------------------- the lossy fabric ---------

def _fault_golden():
    import json
    from pathlib import Path
    return json.loads((Path(__file__).parent / "golden"
                       / "faults_enabled.json").read_text())


def _windows_runs():
    return [r for r in _fault_golden()["small"]["runs"]
            if r["name"].startswith("homa-windows-")]


@pytest.mark.gpu
@pytest.mark.parametrize("run", _windows_runs(),
                         ids=[r["routing"] for r in _windows_runs()])
def test_lossy_leaf_spine_backends_match_the_fault_golden(cuda, run):
    """A small lossy leaf-spine run with a failed uplink and a failed TOR
    under each routing policy: ``cuda``, ``fused`` and ``reference`` on
    the card give the ``"small"`` golden's outputs bit for bit, one
    kernel launch set per slot on each kernel backend."""
    from repro_torch.core import (FabricConfig, SimConfig, make_messages,
                                  simulate)
    meta = _fault_golden()["small"]["meta"]
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                       up_cap=meta["up_cap"], routing=run["routing"],
                       faults=run["faults"])
    slots = meta["max_slots"]
    for backend, want_n in (("cuda", {"priority_arbiter": 2 * slots,
                                      "srpt_topk": slots,
                                      "ring_insert": 3 * slots}),
                            ("fused", {"fused_slot": slots,
                                       "ring_insert": 3 * slots}),
                            ("reference", {})):
        kernel.reset_launch_counts()
        r = simulate(SimConfig(protocol="homa", n_hosts=meta["n_hosts"],
                               max_slots=slots, ring_cap=meta["ring_cap"],
                               fabric=fab, backend=backend,
                               device="cuda"), tbl)
        n = kernel.launch_counts()
        assert all(n[k] == want_n.get(k, 0) for k in n), (backend, n)
        got = {"completion": [int(x) for x in r.completion],
               "retx_chunks": [int(x) for x in r.retx_chunks],
               "msg_lost_chunks": [int(x) for x in r.msg_lost_chunks],
               "fault_lost_chunks": int(r.fault_lost_chunks),
               "lost_chunks": int(r.lost_chunks),
               "tor_up_lost_chunks": int(r.tor_up_lost_chunks),
               "busy": [round(float(x), 8) for x in r.busy_frac]}
        bad = [k for k in got if got[k] != run[k]]
        assert not bad, (backend, bad)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("routing", ["flowlet", "adaptive"])
def test_fault_window_runs_without_host_sync(cuda, backend, routing):
    """The golden's full-width faults (144 hosts, 9 racks, a failed
    uplink and a failed TOR open at slot 1500): 20 slots from there,
    plans included, enqueue no host sync on either kernel backend."""
    from repro_torch.core import (FabricConfig, SimConfig, make_messages)
    from repro_torch.core.protocols import get_protocol
    from repro_torch.core.sim import (_init_state, prepare, run_slots,
                                      stack_static)
    g = _fault_golden()["full"]
    m = g["meta"]
    tbl = make_messages(m["workload"], n_hosts=m["n_hosts"], load=m["load"],
                        n_messages=m["n_messages"],
                        slot_bytes=m["slot_bytes"], seed=m["seed"])
    cfg = SimConfig(protocol="homa", n_hosts=m["n_hosts"],
                    ring_cap=m["ring_cap"], max_slots=m["slots"],
                    fabric=FabricConfig(racks=m["racks"],
                                        oversub=m["oversub"],
                                        up_cap=m["up_cap"], routing=routing,
                                        faults=g["faults"]),
                    backend=backend, device="cuda")
    proto = get_protocol("homa")
    S1, alloc = prepare(cfg, tbl)
    S, n_sched = stack_static([S1]), proto.n_sched(cfg, alloc)
    st = _init_state(cfg, proto, len(tbl.size))
    st = run_slots(cfg, proto, S, st, n_sched, 1000, 1500)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = run_slots(cfg, proto, S, st, n_sched, 1500, 1520)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(st["f_lost"][0]) > 0


# ------------------------------------------ the host stage and telemetry ----

def _host_golden_script():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "make_torch_host_trace_golden.py"
    spec = importlib.util.spec_from_file_location(
        "make_torch_host_trace_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_golden():
    import json
    from pathlib import Path
    return json.loads((Path(__file__).parent / "golden"
                       / "host_trace_enabled.json").read_text())


def _host_runs():
    return _host_golden()["small"]["runs"]


@pytest.mark.gpu
@pytest.mark.parametrize("run", _host_runs(),
                         ids=[r["name"] for r in _host_runs()])
def test_host_trace_golden_on_kernel_backends(cuda, run):
    """A run of ``tests/golden/host_trace_enabled.json``'s ``"small"``
    part on ``cuda`` and ``fused``: every state array by digest, the
    ledger rows, the trace's scalars and the host summary bit for bit,
    with one launch set a slot."""
    from repro_torch.core import (FabricConfig, ReceiverPolicy, SimConfig,
                                  TraceConfig, make_messages, simulate)
    from repro_torch.core.protocols import get_protocol
    gs = _host_golden_script()
    meta = _host_golden()["small"]["meta"]
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    fab = gs.small_fabric(meta, run["topology"])
    slots = meta["max_slots"]
    recv = type(get_protocol(run["protocol"]).receiver)
    topk = recv.grant_problem is not ReceiverPolicy.grant_problem
    tiers = 1 if fab is None else 2
    inserts = 1 if fab is None else 3
    for backend, want_n in (
            ("cuda", {"priority_arbiter": tiers * slots,
                      "srpt_topk": slots if topk else 0,
                      "ring_insert": inserts * slots}),
            ("fused", {"fused_slot": slots,
                       "ring_insert": inserts * slots})):
        kernel.reset_launch_counts()
        r = simulate(SimConfig(
            protocol=run["protocol"], n_hosts=meta["n_hosts"],
            max_slots=slots, ring_cap=meta["ring_cap"],
            fabric=None if fab is None else FabricConfig(**fab),
            host=run["host_cfg"],
            trace=None if run["trace_cfg"] is None
            else TraceConfig(**run["trace_cfg"]),
            backend=backend, device="cuda"), tbl, return_state=True)
        n = kernel.launch_counts()
        assert all(n[k] == want_n.get(k, 0) for k in n), (backend, n)
        bad = gs.differences(run, gs.record(r, r.state))
        assert not bad, (backend, bad)


def _sentinel_cases():
    return [(name, proto) for name in ("fabric_disabled", "fabric_enabled")
            for proto in ("homa", "basic", "phost", "pias", "pfabric",
                          "ndp")]


@pytest.mark.gpu
@pytest.mark.parametrize("name, proto", _sentinel_cases())
def test_off_sentinels_match_the_fabric_goldens(cuda, name, proto):
    """``host="ideal"`` with ``TraceConfig(enabled=False)`` is the
    simulator without either stage: each fabric golden's run of every
    protocol bit-exact, on ``cuda`` for the single switch and on
    ``fused`` for the fabric."""
    import json
    from pathlib import Path
    from repro_torch.core import (FabricConfig, SimConfig, TraceConfig,
                                  make_messages, simulate)
    g = json.loads((Path(__file__).parent / "golden" / f"{name}.json")
                   .read_text())
    meta, want = g["meta"], g["protocols"][proto]
    fab = (FabricConfig(racks=meta["racks"], oversub=meta["oversub"],
                        up_cap=meta["up_cap"])
           if name == "fabric_enabled" else None)
    tbl = make_messages(meta["workload"], n_hosts=meta["n_hosts"],
                        load=meta["load"], n_messages=meta["n_messages"],
                        slot_bytes=meta["slot_bytes"], seed=meta["seed"])
    r = simulate(SimConfig(protocol=proto, n_hosts=meta["n_hosts"],
                           max_slots=meta["max_slots"],
                           ring_cap=meta["ring_cap"], fabric=fab,
                           host="ideal", trace=TraceConfig(enabled=False),
                           backend="cuda" if fab is None else "fused",
                           device="cuda"), tbl, return_state=True)
    assert not any(k.startswith(("h_", "tr_")) for k in r.state)
    got = {"completion": [int(x) for x in r.completion],
           "lost_chunks": int(r.lost_chunks),
           "q_max_bytes": [int(x) for x in r.q_max_bytes],
           "prio_drained_bytes": [int(x) for x in r.prio_drained_bytes],
           "busy": [round(float(x), 8) for x in r.busy_frac]}
    if fab is not None:
        got["tor_up_q_max_bytes"] = [int(x) for x in r.tor_up_q_max_bytes]
        got["tor_up_lost_chunks"] = int(r.tor_up_lost_chunks)
    assert got == want


# ------------------------------------------------------------- training ----

# the card's fp32 training step against the CPU's on one reduced config
# (TF32 off, so the two differ only in the order of fp32 sums): the loss
# relative, each gradient leaf and each AdamW m normwise (max |diff| over
# max |cpu|); tests/test_torch_train.py holds the CPU to JAX
TRAIN_CARD_TOL = dict(loss=1e-5, grad=1e-4)


def _train_inputs(arch, dtype, device):
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_map
    cfg = reduced_config(arch)
    params = init_params(M.model_defs(cfg), torch.Generator()
                         .manual_seed(0), "cpu")
    params = tree_map(lambda p: p.to(device=device, dtype=dtype), params)
    batch = SyntheticLM(DataConfig(seq_len=40, global_batch=4,
                                   vocab_size=cfg.vocab_size,
                                   seed=1)).batch(0)
    return cfg, params, {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}


def _normwise(got, want):
    got, want = got.cpu().float(), want.cpu().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "llama3.2-3b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The fp32 step of the reduced config on the card equals the CPU's
    within fp32 summation order, and launches no hand-written kernel
    (the plain mixers, ROADMAP C2)."""
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.step import build_train_step, value_and_grad
    from repro_torch.tree import flatten
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    got, want = {}, {}
    before = (ssd_kernel.ssd_scan.launches,
              attn_kernel.flash_attention.launches)
    for device, res in ((cuda, got), ("cpu", want)):
        cfg, params, batch = _train_inputs(arch, torch.float32, device)
        res["loss"], _, res["grads"] = value_and_grad(
            lambda p, b: M.loss_fn(cfg, p, b)[0], params, batch)
        step = build_train_step(cfg, oc, grad_accum=2)
        _, res["opt"], res["metrics"] = step(
            params, init_opt_state(params, oc), batch)
    assert (ssd_kernel.ssd_scan.launches,
            attn_kernel.flash_attention.launches) == before
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= TRAIN_CARD_TOL["loss"] * abs(float(want["loss"]))
    for a, b in zip(flatten(got["grads"]) + flatten(got["opt"]["m"]),
                    flatten(want["grads"]) + flatten(want["opt"]["m"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _normwise(a, b) <= TRAIN_CARD_TOL["grad"]


@pytest.mark.gpu
def test_dp_step_on_a_nccl_world_of_one(cuda):
    """The data-parallel step on a NCCL group of one rank (homa, 64 KiB
    chunks, K = 7) computes the single-process step: its sync of one rank
    is the identity, up to the fp32 round trip of bf16 gradients."""
    import torch.distributed as dist
    from repro_torch.distrib import homa_collectives as HC
    from repro_torch.launch.mesh import host_group
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.step import build_train_step
    from repro_torch.tree import flatten
    cfg, params, batch = _train_inputs("llama3.2-3b", torch.float32, cuda)
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    opt = init_opt_state(params, oc)
    _, want_opt, want = build_train_step(cfg, oc, grad_accum=1)(
        params, opt, batch)
    with host_group(cuda) as group:
        assert dist.get_backend(group) == "nccl"
        cfg_s = HC.SyncConfig(chunk_bytes=1 << 16, overcommit=7)
        step = HC.build_dp_train_step(
            lambda p, b: M.loss_fn(cfg, p, b)[0],
            lambda p, g, s: adamw_update(p, g, s, oc), group, cfg_s)
        before = HC.homa_allreduce.collectives
        _, got_opt, got, err = step(params, opt, batch,
                                    HC.init_err_state(params, cfg_s))
        assert HC.homa_allreduce.collectives - before == len(HC.chunk_plan(
            [(tuple(p.shape), p.dtype) for p in flatten(params)], cfg_s))
    assert not dist.is_initialized()
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= TRAIN_CARD_TOL["loss"] * abs(float(want["loss"]))
    for a, b in zip(flatten(got_opt["m"]), flatten(want_opt["m"])):
        assert _normwise(a, b) <= TRAIN_CARD_TOL["grad"]
