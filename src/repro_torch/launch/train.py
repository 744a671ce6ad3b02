"""Training driver: config -> data -> train step -> checkpointed loop,
with fault-tolerant restart and optional Homa-scheduled gradient sync.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        [--smoke] --steps 40 --ckpt-dir /tmp/ckpt [--resume] \
        [--crash-at 20] [--grad-sync pjit|homa|naive] [--compress int8] \
        [--device cpu]

The port of the JAX package's ``launch/train.py``, flag for flag, with
the same printed lines and ``exit(17)`` at ``--crash-at``; ``--device``
(default ``cuda``) picks the card or, for tests, the CPU. ``pjit`` is
the single-process step (``build_train_step``); ``homa`` and ``naive``
run the data-parallel step (``distrib.homa_collectives``) on
``launch.mesh.host_group``: the caller's process group, or a world of
one. The step runs eagerly; the loop reads the loss back once a step.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distrib import homa_collectives as HC
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.step import build_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="simulate preemption: exit(17) after this step")
    ap.add_argument("--grad-sync", choices=["pjit", "homa", "naive"],
                    default="pjit",
                    help="pjit: the single-process step; homa/naive: the "
                         "data-parallel step with SRPT chunks, K = 7, or "
                         "in order, K = 1")
    ap.add_argument("--compress", choices=["int8"], default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; train runs on a card unless "
                           "--device cpu is given")
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    oc = OptConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps,
                   weight_decay=0.01)

    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(M.model_defs(cfg), gen, device)
    opt_state = init_opt_state(params, oc)
    start_step = 0

    store = None
    if args.ckpt_dir:
        store = CheckpointStore(args.ckpt_dir, keep=3)
        if args.resume and store.latest_step() is not None:
            (params, opt_state), start_step = store.restore(
                (params, opt_state), device=device)
            print(f"[train] resumed from step {start_step}")

    dc = DataConfig(seq_len=shape.seq_len, global_batch=shape.global_batch,
                    vocab_size=cfg.vocab_size, seed=args.seed)
    prefetch = Prefetcher(SyntheticLM(dc), start_step)

    losses = []
    step = start_step
    with contextlib.ExitStack() as stack:
        stack.callback(prefetch.close)
        if store:
            stack.callback(store.wait)
        if args.grad_sync in ("homa", "naive"):
            from repro_torch.launch.mesh import host_group
            group = stack.enter_context(host_group(device))
            homa = args.grad_sync == "homa"
            sync_cfg = HC.SyncConfig(chunk_bytes=1 << 16,
                                     compress=args.compress, srpt=homa,
                                     overcommit=7 if homa else 1)
            step_fn = HC.build_dp_train_step(
                lambda p, b: M.loss_fn(cfg, p, b)[0],
                lambda p, g, s: adamw_update(p, g, s, oc), group, sync_cfg)
            err_state = HC.init_err_state(params, sync_cfg)

            def run_step(params, opt_state, batch):
                nonlocal err_state
                params, opt_state, metrics, err_state = step_fn(
                    params, opt_state, batch, err_state)
                return params, opt_state, metrics
        else:
            run_step = build_train_step(cfg, oc, grad_accum=1)

        t0 = time.time()
        while step < args.steps:
            dstep, batch = prefetch.next()
            assert dstep == step, (dstep, step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            params, opt_state, metrics = run_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                dt = (time.time() - t0) / max(step - start_step, 1)
                print(f"[train] step {step} loss {loss:.6f} "
                      f"gnorm {float(metrics.get('grad_norm', 0)):.3f} "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
            if store and step % args.ckpt_every == 0:
                store.save(step, (params, opt_state))
            if args.crash_at is not None and step >= args.crash_at:
                print(f"[train] simulated preemption at step {step}",
                      flush=True)
                sys.exit(17)        # the stack waits for the save

    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "steps": step}
    print(f"[train] done: {result}")
    return result


if __name__ == "__main__":
    main()
