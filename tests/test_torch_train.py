"""The port's training path (``forward_train``, ``loss_fn``,
``training.step``, ``launch.train``) against the JAX package on the CPU,
at ``reduced_config`` of ``mamba2-130m`` and ``llama3.2-3b``.

One parameter tree is drawn by the JAX package's ``init_params`` and
carried across bit for bit by ``convert.params_from_jax``; batches come
from the (shared) synthetic data pipeline. JAX differentiates with
``jax.value_and_grad`` (compiled), the port with ``torch.autograd``.

- ``f32`` (parameters cast to fp32): the two differ only in the order of
  fp32 sums. Loss within rtol 1e-6 (measured 1.7e-7), each gradient leaf
  normwise (max |port - jax| over max |jax|) within 1e-4 (measured
  2.3e-5).
- ``bf16``, as the models run: a flipped bf16 rounding in the backward
  pass is carried and amplified through the layers, so JAX's own bf16
  gradients lie 1-23% (relative RMS, per leaf) from its fp32 gradients
  on these configs. The port's are held to be as close to JAX's fp32
  gradients as JAX's bf16 gradients are: per leaf, rel RMS(port bf16,
  jax fp32) <= 4 x rel RMS(jax bf16, jax fp32) + 1e-3 (the ratio
  measured over 20 seeds: at most 2.4 for mamba, 1.1 for llama); the
  loss within rtol 5e-4 (measured 1.1e-4).
- The 10-step smoke loss curve (AdamW, the launcher's schedule) from the
  same parameters and batches: per step within rtol 2e-5 in fp32
  (measured 6.3e-6) and, in bf16, 5e-3 for mamba and 3e-4 for llama
  (measured 1.3e-3 and 7.7e-5: the gradient noise above moves the
  updates).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.reduced import reduced_config as jreduced
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distrib import sharding as JSH
from repro.models import model as JM
from repro.models.params import init_params as jinit
from repro.training import optimizer as JO
from repro.training import step as JS
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.training import optimizer as O
from repro_torch.training import step as ST
from repro_torch.tree import flatten

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-130m", "llama3.2-3b"]
F32_TOL = dict(loss=1e-6, grad=1e-4)
BF16_TOL = dict(loss=5e-4, ratio=4.0, floor=1e-3)
CURVE_TOL = {("mamba2-130m", "f32"): 2e-5, ("llama3.2-3b", "f32"): 2e-5,
             ("mamba2-130m", "bf16"): 5e-3, ("llama3.2-3b", "bf16"): 3e-4}
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=10, weight_decay=0.01)


def _params(arch, dtype, seed=0):
    jp = jinit(JM.model_defs(jreduced(arch)), jax.random.key(seed))
    if dtype == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed, step=0, B=2, S=24, masked=True):
    b = SyntheticLM(DataConfig(seq_len=S, global_batch=B,
                               vocab_size=cfg.vocab_size, seed=seed)) \
        .batch(step)
    if masked:
        b["labels"][0, :3] = -1
    return b


def _jax_grads(arch, jp, batch):
    cfg = jreduced(arch)
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), aux, [np.asarray(x.astype(jnp.float32))
                              for x in jax.tree.leaves(g)]


def _port_grads(arch, tp, batch, **kw):
    cfg = reduced_config(arch)
    loss, aux, g = ST.value_and_grad(
        lambda p, b: M.loss_fn(cfg, p, b, **kw), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()}, has_aux=True)
    return float(loss), aux, g


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_shapes_match_jax():
    assert set(SHAPES) == set(JSHAPES)
    for k, s in SHAPES.items():
        j = JSHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) \
            == (j.name, j.seq_len, j.global_batch, j.kind, j.is_decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_choose_grad_accum_matches_jax(arch):
    shapes = list(SHAPES.values()) + [ShapeConfig("cli", 2048, 16, "train"),
                                      ShapeConfig("cli", 64, 8, "train"),
                                      ShapeConfig("cli", 4096, 12, "train")]
    for sizes in ({"data": 1}, {"data": 4}, {"data": 3, "model": 2},
                  {"pod": 2, "data": 4, "model": 8}, {"data": 16}):
        for s in shapes:
            js = JShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
            assert ST.batch_axes(sizes, s.global_batch) \
                == JSH.batch_axes(sizes, s.global_batch)
            assert ST.choose_grad_accum(get_config(arch), s, sizes) \
                == JS.choose_grad_accum(jget_config(arch), js, sizes), \
                (sizes, s)
    assert ST.choose_grad_accum(get_config("mamba2-130m"),
                                ShapeConfig("cli", 2048, 16, "train"),
                                {"data": 1}) == 2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0])
def test_loss_and_gradients_match_jax_f32(arch, seed):
    jp, tp = _params(arch, "f32", seed)
    batch = _batch(reduced_config(arch), seed)
    jl, jaux, jg = _jax_grads(arch, jp, batch)
    tl, taux, tg = _port_grads(arch, tp, batch)
    assert abs(tl - jl) <= F32_TOL["loss"] * abs(jl)
    for k in ("nll", "zloss"):
        assert abs(float(taux[k]) - float(jaux[k])) \
            <= F32_TOL["loss"] * abs(float(jaux[k])) + 1e-6
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0
    assert len(flatten(tg)) == len(jg)
    for a, b in zip(flatten(tg), jg):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.abs(a.numpy() - b).max() <= F32_TOL["grad"] \
            * np.abs(b).max()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [1])
def test_loss_and_gradients_match_jax_bf16(arch, seed):
    """Each bf16 gradient leaf of the port is about as far from JAX's
    fp32 gradient as JAX's bf16 gradient is (see the docstring)."""
    jp16, tp16 = _params(arch, "bf16", seed)
    jp32, _ = _params(arch, "f32", seed)
    batch = _batch(reduced_config(arch), seed)
    jl, _, j16 = _jax_grads(arch, jp16, batch)
    _, _, j32 = _jax_grads(arch, jp32, batch)
    tl, _, tg = _port_grads(arch, tp16, batch)
    assert abs(tl - jl) <= BF16_TOL["loss"] * abs(jl)
    for a, b16, b32 in zip(flatten(tg), j16, j32):
        assert a.dtype == torch.bfloat16
        assert _rel(a.float().numpy(), b32) <= BF16_TOL["ratio"] \
            * _rel(b16, b32) + BF16_TOL["floor"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_and_remat(arch):
    """grad_accum 2 sums the microbatches' gradients in fp32: against
    grad_accum 1 within fp32 summation order (fp32 parameters; no masked
    label, so both weigh every token alike); remat
    recomputes the same operations, so on the CPU it is bit-identical
    (bf16)."""
    cfg = reduced_config(arch)
    oc = O.OptConfig(**OPT)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, 3, B=4, masked=False).items()}
    _, tp32 = _params(arch, "f32", 3)
    runs = {ga: ST.build_train_step(cfg, oc, grad_accum=ga)(
        tp32, O.init_opt_state(tp32, oc), batch) for ga in (1, 2)}
    assert abs(float(runs[2][2]["loss"]) - float(runs[1][2]["loss"])) \
        <= 1e-6 * abs(float(runs[1][2]["loss"]))
    for a, b in zip(flatten(runs[2][1]["m"]), flatten(runs[1][1]["m"])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    _, tp = _params(arch, "bf16", 3)
    on, off = (_port_grads(arch, tp, _batch(cfg, 3), remat=r)
               for r in (True, False))
    assert on[0] == off[0]
    for a, b in zip(flatten(on[2]), flatten(off[2])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_2_matches_jax(arch):
    """One step with grad_accum 2 (fp32 parameters) against JAX's: the
    loss, and AdamW's m (the clipped mean gradient) normwise."""
    cfg, jcfg = reduced_config(arch), jreduced(arch)
    jp, tp = _params(arch, "f32", 4)
    batch = _batch(cfg, 4, B=4)
    jo, to = JO.OptConfig(**OPT), O.OptConfig(**OPT)
    _, js, jm = jax.jit(JS.build_train_step(jcfg, jo, grad_accum=2))(
        jp, JO.init_opt_state(jp, jo),
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, ts, tm = ST.build_train_step(cfg, to, grad_accum=2)(
        tp, O.init_opt_state(tp, to),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= F32_TOL["loss"] * abs(float(jm["loss"]))
    for a, b in zip(flatten(ts["m"]), jax.tree.leaves(js["m"])):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= F32_TOL["grad"] \
            * np.abs(b).max()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_smoke_loss_curve_matches_jax(arch, dtype):
    """10 steps of the port's train step against JAX's (jitted), from the
    same parameters and batches."""
    cfg, jcfg = reduced_config(arch), jreduced(arch)
    jp, tp = _params(arch, dtype, 0)
    jo, to = JO.OptConfig(**OPT), O.OptConfig(**OPT)
    jstep = jax.jit(JS.build_train_step(jcfg, jo, grad_accum=1))
    tstep = ST.build_train_step(cfg, to, grad_accum=1)
    js, ts = JO.init_opt_state(jp, jo), O.init_opt_state(tp, to)
    src = SyntheticLM(DataConfig(seq_len=32, global_batch=4,
                                 vocab_size=cfg.vocab_size, seed=0))
    jl, tl = [], []
    for i in range(10):
        b = src.batch(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=3e-7)  # fp32 cos: an ulp
    jl, tl = np.array(jl), np.array(tl)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_TOL[(arch, dtype)])
    assert tl[-1] < tl[0]


def test_forward_train_never_reaches_a_kernel(monkeypatch):
    """ROADMAP C2: the kernels have no backward, so the training path
    runs the plain mixers. With both kernel entry points replaced by
    functions that raise, loss and gradients still compute for both
    models, while a prefill that asks for the kernel reaches them."""
    def boom(*a, **k):
        raise AssertionError("a kernel was called on the training path")

    monkeypatch.setattr(ssd_ops, "ssd", boom)
    monkeypatch.setattr(attn_ops, "attention", boom)
    for arch in ARCHS:
        cfg = reduced_config(arch)
        _, tp = _params(arch, "bf16")
        loss, _, g = _port_grads(arch, tp, _batch(cfg, 0))
        assert np.isfinite(loss) and all(bool(torch.isfinite(x).all())
                                         for x in flatten(g))
        with pytest.raises(AssertionError, match="a kernel was called"):
            M.forward_prefill(cfg, tp, torch.zeros((1, 8), dtype=torch.int32),
                              use_kernel=True)
        lp = M._index(tp["blocks"], 0)["s0"]
        x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="no backward"):
            M.layer_forward(cfg, lp, x, 0, mode="train", use_kernel=True)
        y, cache, _ = M.layer_forward(cfg, lp, x, 0, mode="train")
        assert cache == {} and y.shape == x.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps(arch):
    cfg = reduced_config(arch)
    _, tp = _params(arch, "bf16")
    toks = torch.from_numpy(_batch(cfg, 0)["tokens"][:, :8])
    logits, caches = ST.build_prefill_step(cfg)(tp, {"tokens": toks})
    want, want_c = M.forward_prefill(cfg, tp, toks)
    assert torch.equal(logits, want)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    for pos, fn in ((None, ST.build_serve_step(cfg)),
                    (8, ST.build_serve_step(cfg, pos=8))):
        got, _ = fn(tp, caches, tok, 8 if pos is None else 0)
        assert torch.equal(got, M.forward_decode(cfg, tp, tok, 8, caches)[0])


def _train_cmd(tmp, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "mamba2-130m", "--smoke", "--steps", "20", "--seq-len", "32",
            "--batch", "4", "--log-every", "1", "--device", "cpu",
            *extra]


def _losses(text):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"\[train\] step (\d+) loss (\S+)", text)}


def test_launcher_crash_and_resume(tmp_path):
    """Preemption at step 12 exits 17; the restart resumes from the
    step-10 checkpoint, reaches step 20 and logs the losses of an
    uninterrupted run (the CPU is deterministic), as the JAX package's
    driver does (tests/test_substrate.py)."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    full = subprocess.Popen(_train_cmd(tmp_path), env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        r1 = subprocess.run(_train_cmd(tmp_path, *ck, "--crash-at", "12"),
                            capture_output=True, text=True, env=env,
                            cwd=REPO, timeout=300)
        assert r1.returncode == 17, r1.stderr[-2000:]
        assert "simulated preemption" in r1.stdout
        r2 = subprocess.run(_train_cmd(tmp_path, *ck, "--resume"),
                            capture_output=True, text=True, env=env,
                            cwd=REPO, timeout=300)
        assert r2.returncode == 0, r2.stderr[-2000:]
        out, err = full.communicate(timeout=300)
        assert full.returncode == 0, err[-2000:]
    finally:
        if full.poll() is None:
            full.kill()
            full.wait()
    assert "resumed from step 10" in r2.stdout
    assert "step 20" in r2.stdout
    want, got = _losses(out), _losses(r2.stdout)
    assert sorted(got) == list(range(11, 21))
    assert {s: want[s] for s in got} == got
    assert {s: want[s] for s in range(1, 13)} == _losses(r1.stdout)


def test_launcher_grad_sync_on_a_world_of_one(monkeypatch):
    """``--grad-sync homa`` and ``naive`` run the data-parallel step on a
    gloo world of one, which computes the single-process step; int8
    compression trains too."""
    args = ["--arch", "llama3.2-3b", "--smoke", "--steps", "3", "--seq-len",
            "16", "--batch", "4", "--device", "cpu"]
    base = launch_train.main(args)
    for sync in ("homa", "naive"):
        assert launch_train.main(args + ["--grad-sync", sync]) == base
    res = launch_train.main(args + ["--grad-sync", "homa", "--compress",
                                    "int8"])
    assert np.isfinite(res["final_loss"]) and res["steps"] == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--smoke", "--steps", "1"])
