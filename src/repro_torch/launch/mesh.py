"""Process groups and device meshes: the port's counterpart of the JAX
package's ``launch/mesh.py``.

JAX builds a mesh over the devices one process sees; the port runs one
process per card and syncs over a ``torch.distributed`` group.
``host_group`` uses the default group when the caller has started one
(``init_process_group`` with its own address, world size and rank), and
otherwise starts a world of one over an in-process ``HashStore``: NCCL
on a CUDA device, gloo on the CPU. It reads no environment variable.

``production_mesh`` is ``make_production_mesh``'s counterpart for the dry
run: a ``DeviceMesh`` of 256 or 512 ranks over a fake process group, of
which this process is rank 0. Collectives on it do nothing, so it is
used with tensors that hold no memory (``FakeTensorMode``).
``fake_mesh`` builds the same at any shape. Both are context managers
that refuse to start over an initialized group (``host_group`` would
otherwise adopt the fake world) and destroy theirs on exit. Like JAX's
mesh module, importing this one touches no process group.
"""
from __future__ import annotations

import contextlib
import math

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


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...],
              axes: tuple[str, ...] = ("data", "model"),
              device: str = "cuda"):
    """Yields a ``DeviceMesh`` of ``shape`` named ``axes`` on ``device``
    over a fake process group of ``prod(shape)`` ranks, this process rank
    0; the group is destroyed on exit. Raises if a process group is
    already initialized."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "fake mesh starts its own world")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh(device, tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """The production mesh as a context manager: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return fake_mesh((16, 16), ("data", "model"), device)
