"""Serving driver: Homa-SRPT continuous batching over a model's decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        [--smoke] --requests 64 --batch-size 4 [--no-srpt] [--device cpu]

(``--arch`` takes a registered decoder-only architecture: ``llama3.2-3b``
the dense attention model, ``deepseek-v2-lite-16b`` MLA and MoE; an
encoder-decoder or a model with cross-attention layers is refused, see
:func:`check_servable`.) Reports
per-request slowdown (paper's metric: completion time / ideal time) for
the SRPT scheduler; ``--no-srpt`` runs the FIFO ("Basic") ablation. The
port of the JAX package's ``launch/serve.py`` with the same flags and the
same returned dict; ``--device`` (default ``cuda``) picks the card or,
for tests, the CPU. Decode runs eagerly, one ``forward_decode`` per step
at position 4, as the JAX driver runs it: the first step reads bf16
caches of ``cache_shapes(cfg, batch, 8)``, and each step's caches are the
previous step's deltas (for attention, a one-slot k/v cache; for MLA a
one-slot latent and rope key), which replace the caches rather than
being written into them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import model as M
from repro_torch.models.params import init_params
from repro_torch.serving.scheduler import (HomaScheduler, Request,
                                           SchedulerConfig)


def check_servable(cfg) -> None:
    """Raise ``ValueError`` for a model this loop cannot serve: it swaps
    the caches for each step's decode deltas, which carry no encoder or
    image K/V (``forward_decode`` returns none for them), so the next
    step would find them missing. The JAX package's serve fails on these
    models too, on the mismatch of its cache and delta trees."""
    cross = any(cfg.layer_kind(l) == "cross" for l in range(cfg.num_layers))
    if cfg.is_encoder_decoder or cross:
        what = ("an encoder" if cfg.is_encoder_decoder
                else "cross-attention layers")
        raise ValueError(
            f"serve: {cfg.name} has {what}; the serve replaces its caches "
            f"with each decode step's deltas, which carry no encoder or "
            f"image K/V, so it cannot decode a second step (the JAX "
            f"package's serve fails on it too)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--overcommit", type=int, default=7)
    ap.add_argument("--no-srpt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; serve runs on a card unless "
                           "--device cpu is given")
    cfg = reduced_config(args.arch) if args.smoke else get_config(args.arch)
    check_servable(cfg)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(M.model_defs(cfg), gen, device)
    C = args.batch_size
    sched = HomaScheduler(SchedulerConfig(
        batch_size=C, overcommit=args.overcommit,
        srpt=not args.no_srpt))

    caches = M.zeros_caches(M.cache_shapes(cfg, C, 8), torch.bfloat16,
                            device)
    state = {"caches": caches,
             "tokens": torch.zeros((C, 1), dtype=torch.int32, device=device)}

    rng = np.random.default_rng(args.seed)
    # open-loop Poisson arrivals, heavy-tailed decode lengths (W-like)
    sizes = np.exp(rng.uniform(np.log(2), np.log(200),
                               args.requests)).astype(int)
    arrivals = np.cumsum(rng.exponential(3.0, args.requests))

    def cast_like(old, new):
        if isinstance(old, dict):
            return {k: cast_like(old[k], new[k]) for k in old}
        return new.to(old.dtype)

    def decode_fn(batch):
        logits, deltas = M.forward_decode(cfg, params, state["tokens"], 4,
                                          state["caches"])
        state["caches"] = cast_like(state["caches"], deltas)
        state["tokens"] = logits.argmax(-1).to(torch.int32)[:, None]
        return [r.remaining <= 1 for r in batch]

    t, nxt, steps = 0.0, 0, 0
    t0 = time.time()
    with torch.inference_mode():
        while nxt < args.requests or sched.active or sched.queue:
            while nxt < args.requests and arrivals[nxt] <= t:
                sched.submit(Request(rid=nxt, prompt_len=4,
                                     max_new_tokens=int(sizes[nxt]),
                                     arrival=t))
                nxt += 1
            sched.step(decode_fn, t)
            t += 1.0
            steps += 1
            if steps > 100_000:
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sl = sched.slowdowns()
    out = {"served": len(sched.finished), "steps": steps,
           "mean_slowdown": float(sl.mean()) if len(sl) else None,
           "p99_slowdown": float(np.percentile(sl, 99)) if len(sl) else None,
           "wall_s": round(time.time() - t0, 1)}
    print(f"[serve] {out}")
    return out


if __name__ == "__main__":
    main()
