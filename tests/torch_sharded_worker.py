"""One rank of the 2 x 2 gloo world that ``test_torch_dryrun.py`` starts
(``torch.multiprocessing``, spawn). It imports nothing of JAX.

Each rank reads the test's fp32 parameters and tokens (``inputs.pt``),
places them on a (2, 2) ("data", "model") mesh of real CPU processes by
the JAX package's sharding plan (``distrib.sharding``: parameter specs,
batch axes), runs the plain prefill (``use_kernel=False``) through the
plan's ``cst`` hooks and ``local_map`` regions, then one train step of
two microbatches from fresh AdamW state, and rank 0 saves the gathered
logits, caches, loss and first moments (the clipped gradients, scaled)
to ``out.pt``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist

WORLD = 4


def _placed(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distrib import sharding as SH
    if isinstance(tree, dict):
        return {k: _placed(tree[k], specs[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, SH.placements(specs, mesh))


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor()


def run(rank: int, tmp: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.distrib import sharding as SH
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.step import build_prefill_step, build_train_step
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    inputs = torch.load(tmp / "inputs.pt", weights_only=True)
    out = {}
    for arch, d in inputs.items():
        cfg = reduced_config(arch)
        B, S = d["tokens"].shape
        shape = ShapeConfig("sharded", S, B, "prefill")
        params = _placed(d["params"], SH.model_param_specs(cfg, mesh), mesh)
        bax = SH.batch_axes(SH.mesh_sizes(mesh), B)
        tokens = _placed(d["tokens"], SH.P(bax or None, None), mesh)
        step = build_prefill_step(cfg, mesh=mesh, shape=shape,
                                  use_kernel=False)
        with implicit_replication():
            logits, caches = step(params, {"tokens": tokens})
        out[arch] = {"logits": logits.full_tensor(), "caches": _full(caches),
                     "embed": [str(p) for p in params["embed"].placements]}
        # one train step of two microbatches on the same placements
        oc = OptConfig()
        opt = init_opt_state(params, oc)
        labels = _placed(d["labels"], SH.P(bax or None, None), mesh)
        train = build_train_step(cfg, oc, mesh=mesh, shape=ShapeConfig(
            "sharded", S, B, "train"), grad_accum=2)
        with implicit_replication():
            _, opt, metrics = train(params, opt,
                                    {"tokens": tokens, "labels": labels})
        out[arch]["loss"] = metrics["loss"].full_tensor()
        out[arch]["m"] = _full(opt["m"])
    if rank == 0:
        torch.save(out, tmp / "out.pt")
    dist.destroy_process_group()


def main(tmp: str) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(run, args=(tmp,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    main(sys.argv[1])
