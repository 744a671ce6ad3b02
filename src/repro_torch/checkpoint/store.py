"""Fault-tolerant checkpointing of tensor trees: atomic, asynchronous,
keep-k; the JAX package's ``checkpoint/store.py`` layout and rules.

Layout:  <dir>/step_<N>/
            meta.json       step, leaf count, tree structure, time
            shard_0.pt      the leaves, in flatten order
            COMMIT          written last: a checkpoint without it is
                            ignored (atomic via rename of a temporary
                            directory)

JAX's shard is msgpack compressed with zstd; the port writes the leaves
with ``torch.save`` (a list of CPU tensors in ``jax.tree.flatten``'s
order) and reads them with ``torch.load(weights_only=True)``, which
needs no package beyond PyTorch and keeps every dtype's bits, bf16
included. One process writes one shard. JAX's elastic restore
(``shardings=``, placing each leaf onto another mesh) has no counterpart
on one card: ``restore`` places every leaf on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import torch

from repro_torch.tree import flatten, unflatten

SHARD = "shard_0.pt"


class CheckpointStore:
    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree, *, block: bool = False):
        """Snapshot to host memory synchronously, write to disk (in a
        background thread unless ``block`` or ``async_save=False``),
        commit atomically. At most one save is in flight: this waits for
        the previous one, and raises its error."""
        self.wait()
        host_leaves = [x.detach().to("cpu", copy=True) for x in flatten(tree)]
        structure = repr(unflatten(tree, ["*"] * len(host_leaves)))

        def write():
            try:
                tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                torch.save(host_leaves, tmp / SHARD)
                (tmp / "meta.json").write_text(json.dumps({
                    "step": step, "n_leaves": len(host_leaves),
                    "treedef": structure, "time": time.time()}))
                (tmp / "COMMIT").write_text("ok")
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except Exception as e:  # noqa: BLE001 - raised again at wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()

    def wait(self):
        """Wait for the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def steps(self) -> list[int]:
        """The committed steps, ascending."""
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like, step: int | None = None, *, device=None):
        """Restore into the structure of ``tree_like`` (the latest
        committed step unless ``step`` is given). Each leaf goes to
        ``device``, or else to the device of ``tree_like``'s leaf in its
        place. Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        arrays = torch.load(self.dir / f"step_{step}" / SHARD,
                            map_location="cpu", weights_only=True)
        like = flatten(tree_like)
        if len(arrays) != len(like):
            raise ValueError(f"checkpoint/tree mismatch: {len(arrays)} "
                             f"leaves saved, the tree has {len(like)}")
        arrays = [a.to(device if device is not None else l.device)
                  for a, l in zip(arrays, like)]
        return unflatten(tree_like, arrays), step
