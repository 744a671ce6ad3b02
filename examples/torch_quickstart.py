"""Quickstart on the PyTorch port: the simulator's public API, then
end-to-end training — config, data pipeline, AdamW, checkpointing,
restart. The port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The reduced Mamba2 config, 120 steps; on a CUDA card by default (the
simulator on the staged ``cuda`` kernel backend). The training run is
interrupted at half its steps and restarted from its last checkpoint.
The real ~130M-parameter run (same driver, full config):

    PYTHONPATH=src python examples/torch_quickstart.py --full --steps 300
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def sim_quickstart(device="cuda", backend=None) -> list[str]:
    """30-second tour of the transport-policy API: one structured run,
    then a 4-seed sweep batched on the run axis. Returns the printed
    lines."""
    from repro_torch.core import (SimConfig, SweepSpec, simulate, run_sweep,
                                  registered_protocols, make_messages)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    say(f"registered protocols: {', '.join(registered_protocols())}")
    tbl = make_messages("W1", n_hosts=4, load=0.7, n_messages=200,
                        slot_bytes=256, seed=0)
    cfg = SimConfig(protocol="homa", n_hosts=4, max_slots=2000, ring_cap=256,
                    device=device, backend=backend)
    res = simulate(cfg, tbl)                       # -> SimResult
    say(f"homa: {res.n_complete}/{res.n_messages} complete, "
        f"p99 slowdown {res.percentile(99):.2f}, "
        f"downlink busy {float(res.busy_frac.mean()):.2%}")

    sweep = run_sweep(cfg, SweepSpec(seeds=(0, 1, 2, 3), workload="W1",
                                     load=0.7, n_messages=200,
                                     shared_alloc=True))
    p99s = [r.percentile(99) for r in sweep]
    say(f"4-seed sweep (one batch on the run axis): p99 = "
        f"{', '.join(f'{p:.2f}' for p in p99s)}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="the simulator's: cuda (staged kernels, the "
                         "card's default), fused or reference")
    a = ap.parse_args(argv)

    sim_quickstart(a.device, a.backend)
    from repro_torch.launch import train   # deferred: the training deps

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "mamba2-130m", "--steps", str(a.steps),
                "--seq-len", "128" if not a.full else "1024",
                "--batch", "8", "--lr", "3e-3",
                "--ckpt-dir", a.ckpt_dir or tmp,
                "--ckpt-every", str(a.ckpt_every), "--log-every", "10",
                "--device", a.device]
        if not a.full:
            argv.append("--smoke")
        crash = a.steps // 2
        try:                      # a preemption half-way through ...
            first = train.main(argv + ["--crash-at", str(crash)])
            raise RuntimeError(f"training was not interrupted at step "
                               f"{crash}: {first}")
        except SystemExit as e:
            if e.code != 17:
                raise
        res = train.main(argv + ["--resume"])   # ... and the restart
    if not res["final_loss"] < res["first_loss"]:
        raise RuntimeError(f"loss did not improve: {res}")
    print(f"quickstart OK: loss {res['first_loss']:.3f} -> "
          f"{res['final_loss']:.3f} over {res['steps']} steps (restarted "
          f"after step {crash})")
    return res


if __name__ == "__main__":
    main()
