"""Serving demo on the PyTorch port: the Homa-SRPT scheduler
(``repro_torch.serving``) driving real batched decode of a Mamba2 model
(SSM state caches are position-free, so ragged continuous batching needs
no padding tricks). The port's counterpart of ``examples/serve_demo.py``,
with the same output.

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

The reduced Mamba2-130m config, weights from ``init_params`` with a
seeded ``torch.Generator``; on a CUDA card by default. Decode runs no
hand-written kernel (the SSD kernel serves prefills only). The
scheduler's statistics do not depend on the model.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.reduced import reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.scheduler import (HomaScheduler,  # noqa: E402
                                           Request, SchedulerConfig)


def run(argv=None) -> dict:
    """Serve 24 requests; returns the scheduler's statistics."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    cfg = reduced_config("mamba2-130m")
    params = init_params(M.model_defs(cfg),
                         torch.Generator(device).manual_seed(0), device)
    C = 4                                     # decode slots
    sched = HomaScheduler(SchedulerConfig(batch_size=C, overcommit=3,
                                          unsched_limit=4))

    # per-slot SSM caches (batch dim = C)
    state = {"caches": M.zeros_caches(M.cache_shapes(cfg, C, 1),
                                      torch.bfloat16, device),
             "tokens": torch.zeros((C, 1), dtype=torch.int32,
                                   device=device)}

    rng = np.random.default_rng(0)
    for i in range(24):
        sched.submit(Request(rid=i, prompt_len=4,
                             max_new_tokens=int(rng.integers(2, 24)),
                             arrival=0.0))

    slot_of: dict[int, int] = {}

    def merge(old, new):
        if isinstance(old, dict):
            return {k: merge(old[k], new[k]) for k in old}
        return new.to(old.dtype)

    def decode_fn(batch):
        # place requests into slots (Homa "active" -> decode slot binding)
        free = [s for s in range(C) if s not in slot_of.values()]
        for r in batch:
            if r.rid not in slot_of:
                slot_of[r.rid] = free.pop(0)
        logits, deltas = M.forward_decode(cfg, params, state["tokens"], 1,
                                          state["caches"])
        # merge SSM cache deltas back per served slot
        state["caches"] = merge(state["caches"], deltas)
        state["tokens"] = logits.argmax(-1).to(torch.int32)[:, None]
        done = []
        for r in batch:
            d = r.remaining <= 1
            if d:
                slot_of.pop(r.rid, None)
            done.append(d)
        return done

    t, steps = 0.0, 0
    with torch.inference_mode():
        while (sched.active or sched.queue) and steps < 2000:
            sched.step(decode_fn, t)
            t += 1.0
            steps += 1

    sl = sched.slowdowns()
    print(f"served {len(sched.finished)}/24 requests in {steps} steps")
    print(f"slowdown: mean {sl.mean():.2f}  p99 {np.percentile(sl, 99):.2f}")
    if len(sched.finished) != 24:
        raise RuntimeError(f"served {len(sched.finished)} of 24 requests")
    print("serve_demo OK")
    return {"served": len(sched.finished), "steps": steps,
            "mean_slowdown": float(sl.mean()),
            "p99_slowdown": float(np.percentile(sl, 99))}


if __name__ == "__main__":
    run()
