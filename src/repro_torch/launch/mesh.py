"""The process group the data-parallel step runs on: the port's
counterpart of the JAX package's ``launch/mesh.py`` ``make_host_mesh``.

JAX builds a mesh over the devices one process sees; the port runs one
process per card and syncs over a ``torch.distributed`` group.
``host_group`` uses the default group when the caller has started one
(``init_process_group`` with its own address, world size and rank), and
otherwise starts a world of one over an in-process ``HashStore``: NCCL
on a CUDA device, gloo on the CPU. It reads no environment variable.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


@contextlib.contextmanager
def host_group(device):
    """Yields the group to sync over; a world of one that this started
    is destroyed on exit."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
