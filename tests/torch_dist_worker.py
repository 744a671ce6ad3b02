"""One rank of the 4-process gloo world that ``test_torch_collectives.py``
starts (``torch.multiprocessing``, spawn). It imports nothing of JAX.

Each rank reads the per-rank gradients the test wrote (``grads.npz``),
and saves to ``rank<r>.pt``:
- ``homa`` / ``naive``: ``homa_allreduce`` (chunks of 256 bytes, K = 3)
  and ``naive_allreduce`` of its gradients;
- ``int8`` / ``int8_err``: the int8 sync with error feedback from the
  per-rank error state the test wrote;
- ``in_flight``: for K in (1, 3, 7), the most chunk collectives that
  were issued and not yet waited on, counted by wrappers around
  ``dist.all_reduce`` / ``dist.all_gather`` independently of the code's
  own count;
- ``dp``: one data-parallel step (``build_dp_train_step``, homa, chunks
  of 2 KiB, K = 7) of the reduced Mamba2 model from the test's fp32
  parameters on the test's batch, each rank on its quarter of it.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _tree(npz, prefix, dtypes):
    """The tree the test flattened into ``npz`` keys ``prefix/path``."""
    out = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        path = key[len(prefix) + 1:].split("/")
        t = torch.from_numpy(np.array(npz[key]))
        t = t.to(dtypes.get("/".join(path), t.dtype))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


class _Counted:
    """A collective's handle whose ``wait`` is counted."""

    def __init__(self, work, counter):
        self.work, self.counter = work, counter

    def wait(self):
        self.counter["open"] -= 1
        return self.work.wait()


def _count_in_flight(counter):
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def wrap(name):
        def call(*a, async_op=False, **k):
            work = real[name](*a, async_op=async_op, **k)
            if not async_op:
                return work
            counter["open"] += 1
            counter["max"] = max(counter["max"], counter["open"])
            return _Counted(work, counter)
        return call

    for name in real:
        setattr(dist, name, wrap(name))
    return real


def run(rank: int, tmp: str) -> None:
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.distrib import homa_collectives as HC
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptConfig, adamw_update

    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    group = dist.group.WORLD
    data = np.load(tmp / "grads.npz")
    dtypes = {k: torch.bfloat16 for k in str(data["bf16"]).split(",") if k}
    grads = _tree(data, f"g{rank}", dtypes)
    err = _tree(data, f"e{rank}", {})
    out = {}
    cfg = HC.SyncConfig(chunk_bytes=256, overcommit=3)
    out["homa"], _ = HC.homa_allreduce(grads, group, cfg)
    out["naive"] = HC.naive_allreduce(grads, group)
    icfg = HC.SyncConfig(chunk_bytes=256, overcommit=3, compress="int8")
    out["int8"], out["int8_err"] = HC.homa_allreduce(grads, group, icfg, err)

    counter = {"open": 0, "max": 0}
    real = _count_in_flight(counter)
    out["in_flight"] = {}
    for K in (1, 3, 7):
        for compress in (None, "int8"):
            counter["max"] = 0
            HC.homa_allreduce(grads, group, HC.SyncConfig(
                chunk_bytes=64, overcommit=K, compress=compress), None)
            out["in_flight"][f"{K}/{compress}"] = counter["max"]
    for name, fn in real.items():
        setattr(dist, name, fn)

    cfg_m = reduced_config("mamba2-130m")
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=40,
                   weight_decay=0.01)
    dp = torch.load(tmp / "dp_in.pt", weights_only=True)
    step = HC.build_dp_train_step(
        lambda p, b: M.loss_fn(cfg_m, p, b)[0],
        lambda p, g, s: adamw_update(p, g, s, oc), group,
        HC.SyncConfig(chunk_bytes=2048, overcommit=7))
    params, opt_state, metrics, _ = step(
        dp["params"], dp["opt_state"], dp["batch"],
        HC.init_err_state(dp["params"], HC.SyncConfig()))
    out["dp"] = {"params": params, "opt_state": opt_state,
                 "metrics": metrics}
    torch.save(out, tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


def main(tmp: str) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(run, args=(tmp,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    main(sys.argv[1])
