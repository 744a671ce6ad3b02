"""The gloo worlds of ``test_torch_sweep_sharded.py``: ``python
tests/torch_sweep_worker.py TMP WORLD`` starts WORLD ranks
(``torch.multiprocessing``, spawn; a ``FileStore`` under TMP). Each rank
runs every case of :func:`cases` through ``run_sweep`` and pickles what
it returned, or the exception it raised, to ``TMP/rank<r>.pkl``. It
imports nothing of JAX.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

PROTOCOLS = ("homa", "basic", "phost", "pias", "pfabric", "ndp")
# table lengths (messages) of each world's sweep: 3 runs over 2 ranks pad
# one group to 4; over 3 ranks the 30-message run is a group of its own,
# padded to 3
LENGTHS = {2: (40, 40, 40), 3: (40, 40, 30, 40)}
MAX_SLOTS = 300


def tables(world: int):
    from repro_torch.core import make_messages
    return [make_messages("W1", n_hosts=4, load=0.6, n_messages=m,
                          slot_bytes=256, seed=s)
            for s, m in enumerate(LENGTHS[world])]


def config(protocol: str):
    from repro_torch.core import SimConfig
    return SimConfig(n_hosts=4, max_slots=MAX_SLOTS, ring_cap=256,
                     protocol=protocol, device="cpu")


def spec(world: int, streaming: bool, shard=True):
    from repro_torch.core import SweepSpec
    if streaming:
        return SweepSpec(tables=tables(world), shared_alloc=True,
                         chunk_slots=120, streaming=True, shard=shard)
    return SweepSpec(tables=tables(world), shard=shard)


def cases(world: int) -> dict:
    """name -> (protocol, streaming, shard): every protocol exact and
    streaming over the whole world, and homa streaming over part of it:
    on a world of 2 ``shard=1`` (each rank runs every run itself), on a
    world of 3 ``shard=2`` (rank 2 steps nothing and still returns every
    run)."""
    out = {f"{p}-{'streaming' if s else 'exact'}": (p, s, True)
           for p in PROTOCOLS for s in (False, True)}
    out["homa-streaming-part"] = ("homa", True, world - 1)
    return out


def run(rank: int, tmp: str, world: int) -> None:
    from repro_torch.core import run_sweep, sweep
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), rank=rank, world_size=world)
    out = {}
    for name, (proto, streaming, shard) in cases(world).items():
        out[name] = run_sweep(config(proto), spec(world, streaming, shard))
    # a rank that fails: rank 1's batch raises, and every rank must raise
    real = sweep._run_batch

    def broken(*a, **k):
        raise RuntimeError("injected failure")
    if rank == 1:
        sweep._run_batch = broken
    try:
        run_sweep(config("homa"), spec(world, True))
        out["failure"] = None
    except RuntimeError as e:
        out["failure"] = str(e)
    finally:
        sweep._run_batch = real
    (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


def main(tmp: str, world: int) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(run, args=(tmp, world), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    main(sys.argv[1], int(sys.argv[2]))
