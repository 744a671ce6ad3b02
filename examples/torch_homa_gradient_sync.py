"""Homa-scheduled data-parallel training with the PyTorch port: chunked,
SRPT-ordered, overcommitment-bounded gradient collectives (K = 7), with
optional int8 compression + error feedback, against the naive sync (the
same chunks in order, one at a time). The port's counterpart of
``examples/homa_gradient_sync.py``.

    PYTHONPATH=src python examples/torch_homa_gradient_sync.py \
        [--compress] [--steps 30] [--device cuda]

On the CPU it runs 8 gloo processes (a world of 8, each rank on its
share of the batch); with ``--device cuda``, the card's NCCL world of
one. Rank 0 prints each sync's first and last loss and its time per step.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch
import torch.distributed as dist

from repro_torch.configs.reduced import reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distrib import homa_collectives as HC
from repro_torch.launch.mesh import host_group
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state)
from repro_torch.tree import tree_map

CPU_WORLD = 8


def train(group, device, args) -> dict:
    cfg = reduced_config("llama3.2-3b")
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps,
                   weight_decay=0.01)
    src = SyntheticLM(DataConfig(seq_len=64, global_batch=16,
                                 vocab_size=cfg.vocab_size))
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in src.batch(i).items()} for i in range(args.steps)]
    out = {}
    for name in ("homa", "naive"):
        homa = name == "homa"
        scfg = HC.SyncConfig(chunk_bytes=1 << 14, srpt=homa,
                             overcommit=7 if homa else 1,
                             compress="int8" if args.compress else None)
        params = tree_map(lambda p: p.to(device), init_params(
            M.model_defs(cfg), torch.Generator().manual_seed(0), "cpu"))
        opt = init_opt_state(params, oc)
        err = HC.init_err_state(params, scfg)
        step = HC.build_dp_train_step(
            lambda p, b: M.loss_fn(cfg, p, b)[0],
            lambda p, g, s: adamw_update(p, g, s, oc), group, scfg)
        losses, t0 = [], None
        for i, batch in enumerate(batches):
            if i == 1:                  # the first step is the warm-up
                _sync(device)
                t0 = time.perf_counter()
            params, opt, metrics, err = step(params, opt, batch, err)
            losses.append(float(metrics["loss"]))
        _sync(device)
        out[name] = (losses[0], losses[-1],
                     (time.perf_counter() - t0) / (len(batches) - 1) * 1e3)
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def report(out, world, args):
    for name, (first, last, ms) in out.items():
        print(f"{name:5s}: loss {first:.3f} -> {last:.3f}, {ms:.1f} ms/step")
    assert all(last < first for first, last, _ in out.values()), out
    print(f"torch_homa_gradient_sync OK ({'int8' if args.compress else 'f32'}"
          f" on the wire) on a world of {world}")


def cpu_rank(rank, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, CPU_WORLD),
                            rank=rank, world_size=CPU_WORLD)
    try:
        out = train(dist.group.WORLD, "cpu", args)
        if rank == 0:
            report(out, CPU_WORLD, args)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        with host_group(args.device) as group:
            report(train(group, args.device, args), group.size(), args)
        return
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(cpu_rank, args=(str(Path(tmp) / "store"), args),
                           nprocs=CPU_WORLD, start_method="spawn")


if __name__ == "__main__":
    main()
