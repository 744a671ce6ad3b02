"""The port's Homa-scheduled gradient sync (``repro_torch.distrib``)
against the JAX package on the CPU.

- ``chunk_plan`` is pure Python: the same list as JAX's for the same
  shapes and dtypes.
- ``_quantize`` is bit-identical to JAX's as XLA compiles it (JAX's
  ``_quantize`` runs only inside ``jit``; see the port's docstring).
- ``homa_allreduce`` runs on a 4-process gloo world
  (``tests/torch_dist_worker.py``), with distinct gradients per rank,
  and is held to ``naive_allreduce`` in that world and to JAX's
  ``homa_allreduce`` on 4 forced host devices (a subprocess) on the same
  per-rank gradients: rtol 1e-6 of the mean of the ranks' |g| (fp32
  sums over 4 ranks in another order, whose terms cancel; measured
  1.5e-7); with int8, the error state bit-identical (it is
  xf - q·scale, so q and the scale are too).
- The at-most-K-outstanding bound, counted by wrappers around the
  collectives, and the data-parallel step on 4 ranks against the
  single-process step on the whole batch.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distrib import homa_collectives as JH
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distrib import homa_collectives as H
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.step import build_train_step
from repro_torch.tree import flatten, paths, tree_map

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}
WORLD = 4
# the per-rank gradient tree: (path, shape, dtype)
LEAVES = [("a", (3, 333), "f32"), ("b/c", (17,), "bf16"),
          ("d", (64, 64), "bf16"), ("e", (), "f32"), ("f", (2000,), "f32")]
SYNC_RTOL = 1e-6
# the DP step (fp32 parameters) against the single-process step on the
# whole batch: the loss (relative) and AdamW's m (the clipped mean
# gradient times 1 - b1; max |diff| over max |m|, per leaf) within fp32
# summation-order differences; measured 0 and 4.3e-7 on these inputs
DP_TOL = dict(loss=1e-6, m=2e-6)


@pytest.mark.parametrize("shapes", [
    [((3, 333), "float32"), ((17,), "bfloat16"), ((), "float32"),
     ((64, 64), "bfloat16"), ((100000,), "float32")],
    [((1,), "bfloat16"), ((5, 7, 3), "float32"), ((4096,), "bfloat16"),
     ((4096,), "bfloat16")],
])
@pytest.mark.parametrize("chunk_bytes", [6, 256, 4000, 1 << 16])
@pytest.mark.parametrize("srpt", [True, False])
def test_chunk_plan_matches_jax(shapes, chunk_bytes, srpt):
    want = JH.chunk_plan([(s, jnp.dtype(d)) for s, d in shapes],
                         JH.SyncConfig(chunk_bytes=chunk_bytes, srpt=srpt))
    got = H.chunk_plan([(s, getattr(torch, d)) for s, d in shapes],
                       H.SyncConfig(chunk_bytes=chunk_bytes, srpt=srpt))
    assert [(c.leaf, c.start, c.size, c.bytes, c.remaining) for c in got] \
        == [(c.leaf, c.start, c.size, c.bytes, c.remaining) for c in want]


@pytest.mark.parametrize("scale", [1e-30, 3e-7, 1e-3, 1.0, 1e4])
@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(scale, with_err, dtype):
    import jax
    rng = np.random.default_rng(int(scale * 1e3) % 97 + with_err)
    for n in (1, 7, 4097, 60000):
        x = (rng.standard_normal(n) * scale).astype(np.float32)
        x[:min(n, 6)] = (np.array([0.5, 1.5, 2.5, -0.5, -2.5, 0.0])
                         * scale)[:min(n, 6)]
        x = np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))
        e = (rng.standard_normal(n) * scale * 1e-2).astype(np.float32)
        want = jax.jit(JH._quantize)(jnp.asarray(x).astype(dtype),
                                     jnp.asarray(e) if with_err else None)
        got = H._quantize(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(e) if with_err else None)
        for w, g, name in zip(want, got, ("q", "scale", "err")):
            assert np.asarray(w).tobytes() == g.numpy().tobytes(), (name, n)
        assert got[0].dtype == torch.int8


def _bf16_exact(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


JAX_SCRIPT = """
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.distrib import homa_collectives as HC

tmp = sys.argv[1]
data = np.load(tmp + "/grads.npz")
bf16 = set(str(data["bf16"]).split(","))
names = sorted(k[3:] for k in data.files if k.startswith("g0/"))


def stacked(prefix, cast):
    out = {}
    for n in names:
        a = np.stack([data[f"{prefix}{r}/{n}"] for r in range(4)])
        a = jnp.asarray(a)
        if cast and n in bf16:
            a = a.astype(jnp.bfloat16)
        node = out
        *head, last = n.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


mesh = jax.make_mesh((4,), ("data",))


@jax.jit
@partial(jax.shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
         out_specs=(P(), P(), P("data")), check_vma=False)
def sync(g, e):
    g = jax.tree.map(lambda x: x[0], g)
    e = jax.tree.map(lambda x: x[0], e)
    h, _ = HC.homa_allreduce(g, "data",
                             HC.SyncConfig(chunk_bytes=256, overcommit=3))
    i, ie = HC.homa_allreduce(
        g, "data", HC.SyncConfig(chunk_bytes=256, overcommit=3,
                                 compress="int8"), e)
    return h, i, jax.tree.map(lambda x: x[None], ie)


h, i, ie = sync(stacked("g", True), stacked("e", False))
out = {}
for tag, tree in (("homa", h), ("int8", i), ("int8_err", ie)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        out[f"{tag}/{key}"] = np.asarray(leaf.astype(jnp.float32))
np.savez(tmp + "/jax_out.npz", **out)
"""


def _dp_inputs():
    cfg = reduced_config("mamba2-130m")
    params = init_params(M.model_defs(cfg), torch.Generator().manual_seed(3),
                         "cpu")
    params = tree_map(lambda p: p.float(), params)
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=40,
                   weight_decay=0.01)
    batch = SyntheticLM(DataConfig(seq_len=16, global_batch=8,
                                   vocab_size=cfg.vocab_size, seed=5)).batch(2)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return cfg, oc, {"params": params, "opt_state": init_opt_state(params, oc),
                     "batch": batch}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Per-rank gradients and error states; the 4-rank gloo world's and
    the JAX subprocess's results, both run at once."""
    tmp = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(11)
    arrays, grads = {}, []
    for r in range(WORLD):
        tree = {}
        for path, shape, dt in LEAVES:
            a = (rng.standard_normal(shape) * (r + 1)).astype(np.float32)
            if dt == "bf16":
                a = _bf16_exact(a)
            arrays[f"g{r}/{path}"] = a
            arrays[f"e{r}/{path}"] = (rng.standard_normal(
                int(np.prod(shape))) * 1e-2).astype(np.float32)
            tree[path] = a
        grads.append(tree)
    arrays["bf16"] = np.array(",".join(p for p, _, d in LEAVES if d == "bf16"))
    np.savez(tmp / "grads.npz", **arrays)
    cfg, oc, dp_in = _dp_inputs()
    torch.save(dp_in, tmp / "dp_in.pt")
    env = {**ENV, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        r = subprocess.run([sys.executable, str(REPO / "tests" /
                                                "torch_dist_worker.py"),
                            str(tmp)], env=ENV, cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        _, err = jax_run.communicate(timeout=300)
        assert jax_run.returncode == 0, err[-3000:]
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
             for r in range(WORLD)]
    return {"grads": grads, "arrays": arrays, "ranks": ranks,
            "jax": dict(np.load(tmp / "jax_out.npz")),
            "dp_in": dp_in, "cfg": cfg, "oc": oc}


def _leaves(tree):
    return {"/".join(p): x for p, x in zip(paths(tree), flatten(tree))}


def _close(got, want, grads, path, what):
    """|got - want| <= SYNC_RTOL times the mean over ranks of |g_r|,
    elementwise: the rtol of a sum whose terms cancel is taken on the
    terms, since sums in another order differ by ulps of the terms."""
    scale = np.mean([np.abs(g[path]) for g in grads], axis=0)
    got = np.asarray(got, np.float32)
    bad = np.abs(got - want) > SYNC_RTOL * scale
    assert not bad.any(), (what, path, int(bad.sum()),
                           float(np.abs(got - want).max()))


def test_homa_allreduce_matches_naive_on_4_ranks(world):
    """Every rank gets the same mean, equal to the mean of the per-rank
    gradients, in each leaf's dtype; homa (chunked, SRPT, K = 3) and
    naive (one collective per leaf) agree."""
    want = {p: np.mean([g[p] for g in world["grads"]], axis=0)
            for p, _, _ in LEAVES}
    dtypes = {p: d for p, _, d in LEAVES}
    for rank in world["ranks"]:
        homa, naive = _leaves(rank["homa"]), _leaves(rank["naive"])
        for p in want:
            assert homa[p].dtype == (torch.bfloat16 if dtypes[p] == "bf16"
                                     else torch.float32)
            assert naive[p].dtype == torch.float32
            _close(homa[p].float().numpy(),
                   naive[p].to(homa[p].dtype).float().numpy(),
                   world["grads"], p, "homa vs naive")
            _close(naive[p].numpy(), want[p], world["grads"], p,
                   "naive vs mean")
        assert torch.equal(flatten(rank["homa"])[0],
                           flatten(world["ranks"][0]["homa"])[0])


def test_homa_allreduce_matches_jax_on_4_ranks(world):
    """The same per-rank gradients through JAX's ``homa_allreduce`` on 4
    host devices: the synced gradients within rtol 1e-6, and with int8
    compression the new error state bit for bit on every rank."""
    jx = world["jax"]
    for r, rank in enumerate(world["ranks"]):
        for tag in ("homa", "int8"):
            for p, x in _leaves(rank[tag]).items():
                _close(x.float().numpy(), jx[f"{tag}/{p}"], world["grads"],
                       p, f"{tag} rank {r}")
        for p, x in _leaves(rank["int8_err"]).items():
            assert x.dtype == torch.float32
            assert x.numpy().tobytes() == jx[f"int8_err/{p}"][r].tobytes(), \
                (p, r)
        assert any(bool(x.abs().max() > 0)
                   for x in flatten(rank["int8_err"]))


def test_at_most_k_chunk_collectives_in_flight(world):
    """Counted by wrappers around the collectives: with K lanes, the
    outstanding chunk collectives reach K and never exceed it."""
    for rank in world["ranks"]:
        for key, most in rank["in_flight"].items():
            K = int(key.split("/")[0])
            assert most == K, (key, most)


def test_dp_step_on_4_ranks_matches_single_process_step(world):
    """Each rank's quarter of the batch, grads synced by homa, then AdamW:
    equal to the single-process step on the whole batch (fp32
    parameters); every rank ends with the same parameters."""
    cfg, oc, dp_in = world["cfg"], world["oc"], world["dp_in"]
    step = build_train_step(cfg, oc, grad_accum=1)
    params, opt_state, metrics = step(dp_in["params"], dp_in["opt_state"],
                                      dp_in["batch"])
    ranks = [r["dp"] for r in world["ranks"]]
    for got in ranks:
        assert abs(float(got["metrics"]["loss"]) - float(metrics["loss"])) \
            <= DP_TOL["loss"] * abs(float(metrics["loss"]))
        for a, b in zip(flatten(got["opt_state"]["m"]),
                        flatten(opt_state["m"])):
            assert float((a - b).abs().max()) \
                <= DP_TOL["m"] * float(b.abs().max()) + 1e-12
        for a, b in zip(flatten(got["params"]),
                        flatten(ranks[0]["params"])):
            assert torch.equal(a, b)
        assert int(got["opt_state"]["step"]) == 1


def test_err_state_and_counters():
    """``init_err_state`` is a flat fp32 zero per leaf with int8 error
    feedback, else one fp32 zero; the counters count chunk collectives."""
    params = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
              "b": torch.zeros(5)}
    e = H.init_err_state(params, H.SyncConfig(compress="int8"))
    assert [tuple(x.shape) for x in flatten(e)] == [(12,), (5,)]
    assert all(x.dtype == torch.float32 for x in flatten(e))
    z = H.init_err_state(params, H.SyncConfig())
    assert z.shape == () and float(z) == 0.0
    import torch.distributed as dist
    from repro_torch.launch.mesh import host_group
    with host_group("cpu") as group:
        before = H.homa_allreduce.collectives
        out, _ = H.homa_allreduce(params, group, H.SyncConfig(chunk_bytes=8))
        n = len(H.chunk_plan([((3, 4), torch.bfloat16), ((5,), torch.float32)],
                             H.SyncConfig(chunk_bytes=8)))
        assert H.homa_allreduce.collectives - before == n
        assert all(torch.equal(a, b) for a, b in zip(flatten(out),
                                                       flatten(params)))
    assert not dist.is_initialized()
