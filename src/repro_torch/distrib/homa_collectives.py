"""Homa-inspired gradient-sync scheduling (DESIGN.md §2.2) on
``torch.distributed``: the JAX package's ``distrib/homa_collectives.py``.

What transfers from the paper:

- **Message orientation** (paper §3.1): gradients are synced as
  independent size-bounded *chunks*, never as one fused collective, so a
  small tensor is not head-of-line blocked behind a large one.
- **SRPT issue order** (§3.2): chunks are issued shortest-remaining-first.
- **Controlled overcommitment** (§3.5): at most K chunk collectives are
  in flight. JAX encodes the K lanes as ``optimization_barrier`` chains
  for XLA's scheduler; eagerly, each chunk is an asynchronous collective
  (``async_op=True``) issued in the plan's order, and chunk i waits on
  chunk i - K's handle before it is issued, so no more than K are ever
  outstanding (asserted, and recorded in
  ``homa_allreduce.max_in_flight``).

int8 compression with error feedback composes with the chunking: a
compressed chunk moves as int8 (with its fp32 scale) by ``all_gather``
and is reduced locally, as in JAX. The port packs each chunk's scale
behind its int8 values, so a chunk is one collective either way.
``homa_allreduce.collectives`` counts the chunk collectives issued.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.training.step import value_and_grad
from repro_torch.tree import flatten, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    chunk_bytes: int = 4 << 20          # 4 MB chunks (RTTbytes analogue)
    overcommit: int = 7                 # K lanes (paper: # sched priorities)
    srpt: bool = True                   # shortest-first issue order
    compress: str | None = None         # None | "int8"
    error_feedback: bool = True


@dataclasses.dataclass(frozen=True)
class Chunk:
    leaf: int            # flat leaf index
    start: int           # element offset
    size: int            # element count
    bytes: int
    remaining: int       # bytes remaining in this leaf incl. this chunk (SRPT key)


def chunk_plan(shapes: list[tuple[tuple[int, ...], torch.dtype]],
               cfg: SyncConfig) -> list[Chunk]:
    """Static chunking + SRPT schedule over grad leaves ((shape, torch
    dtype) pairs, in flatten order).

    SRPT key: bytes remaining in the leaf at the time this chunk would be
    sent, so all of a small tensor beats the tail of a big one, and a big
    tensor's last chunks rise in priority as it completes."""
    chunks: list[Chunk] = []
    for i, (shape, dtype) in enumerate(shapes):
        n = math.prod(shape)
        isz = dtype.itemsize
        per = max(cfg.chunk_bytes // isz, 1)
        total_b = n * isz
        off = 0
        while off < n:
            size = min(per, n - off)
            chunks.append(Chunk(i, off, size, size * isz,
                                remaining=total_b - off * isz))
            off += size
    if cfg.srpt:
        chunks.sort(key=lambda c: (c.remaining, c.leaf, c.start))
    return chunks


def _quantize(x, err):
    """int8 values, their fp32 scale and the new error of ``x`` plus the
    carried error ``err`` (or none), bit for bit as XLA compiles the JAX
    package's ``_quantize`` (which runs only inside ``jit``): XLA turns
    the division of the max by the constant 127 into a product with
    fp32(1/127), and contracts ``xf - q * scale`` into one fused
    multiply-add, so the residual is rounded once. Here the residual is
    taken in float64, where it is exact (q has 8 bits, the scale 24, and
    both terms lie within a few binades of the scale), then rounded to
    fp32. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.to(F32) + (err if err is not None else 0.0)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = (xf.double() - q.double() * scale.double()).to(F32)
    return q, scale, new_err


def homa_allreduce(grads, group, cfg: SyncConfig, err_state=None):
    """Mean-allreduce a grad tree over ``group`` in chunked, SRPT-ordered
    collectives, at most ``cfg.overcommit`` in flight.

    Returns (synced grads in each leaf's dtype, new error state: a tree of
    flat fp32 errors with int8 compression and error feedback, else
    None)."""
    leaves = flatten(grads)
    plan = chunk_plan([(tuple(l.shape), l.dtype) for l in leaves], cfg)
    flat = [l.reshape(-1) for l in leaves]
    feedback = bool(cfg.compress) and cfg.error_feedback
    err_flat = (flatten(err_state) if feedback and err_state is not None
                else [None] * len(leaves))
    nshards = dist.get_world_size(group)

    out = [torch.zeros(f.shape, dtype=F32, device=f.device) for f in flat]
    new_err = [torch.zeros(f.shape, dtype=F32, device=f.device)
               for f in flat] if feedback else None

    K = max(cfg.overcommit, 1)
    in_flight: collections.deque = collections.deque()

    def retire():
        work, ch, buf = in_flight.popleft()
        work.wait()
        if cfg.compress == "int8":
            qg, sg = buf[:, :ch.size], buf[:, ch.size:].contiguous().view(F32)
            red = torch.sum(qg.to(F32) * sg, dim=0) / nshards
        else:
            red = buf / nshards
        out[ch.leaf][ch.start:ch.start + ch.size] = red

    for ch in plan:
        if len(in_flight) == K:
            retire()            # chunk i waits on chunk i - K
        piece = flat[ch.leaf][ch.start:ch.start + ch.size]
        if cfg.compress == "int8":
            e = err_flat[ch.leaf]
            q, scale, e_new = _quantize(
                piece, None if e is None else e[ch.start:ch.start + ch.size])
            if feedback:
                new_err[ch.leaf][ch.start:ch.start + ch.size] = e_new
            # int8 on the wire: the values and their scale's 4 bytes
            send = torch.cat([q, scale.reshape(1).view(torch.int8)])
            buf = torch.empty((nshards, send.numel()), dtype=torch.int8,
                              device=send.device)
            work = dist.all_gather(list(buf.unbind(0)), send, group=group,
                                   async_op=True)
        else:
            buf = piece.to(F32, copy=True)
            work = dist.all_reduce(buf, group=group, async_op=True)
        in_flight.append((work, ch, buf))
        homa_allreduce.collectives += 1
        assert len(in_flight) <= K, "more chunk collectives in flight than K"
        homa_allreduce.max_in_flight = max(homa_allreduce.max_in_flight,
                                           len(in_flight))
    while in_flight:
        retire()

    synced = [o.reshape(l.shape).to(l.dtype) for o, l in zip(out, leaves)]
    err_out = unflatten(grads, new_err) if feedback else None
    return unflatten(grads, synced), err_out


homa_allreduce.collectives = 0      # chunk collectives issued, all calls
homa_allreduce.max_in_flight = 0    # most outstanding at once, all calls


def naive_allreduce(grads, group):
    """Baseline: one blocking all-reduce per leaf, in fp32 (the
    'streaming' pattern the paper argues against)."""
    n = dist.get_world_size(group)

    def one(g):
        buf = g.to(F32, copy=True)
        dist.all_reduce(buf, group=group)
        return buf / n

    return tree_map(one, grads)


def build_dp_train_step(loss_fn: Callable, opt_update: Callable, group,
                        cfg: SyncConfig | None = None):
    """Pure-data-parallel train step with explicit Homa-scheduled grad
    sync over ``group``, one process per rank.

    Params are replicated; each rank takes its contiguous share of the
    batch (rank r the r-th of ``world_size`` equal slices of dim 0).
    ``loss_fn(params, batch)`` -> scalar; ``opt_update(params, grads,
    opt_state)`` -> (params, opt_state, metrics). Returns
    ``step(params, opt_state, batch, err_state)`` -> (params, opt_state,
    metrics, err_state), with the loss averaged over ranks in
    ``metrics["loss"]``."""
    cfg = cfg or SyncConfig()

    def step(params, opt_state, batch, err_state):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        local = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does "
                                 f"not split over {n} ranks")
            local[k] = v.reshape((n, v.shape[0] // n) + v.shape[1:])[r]
        loss, _, grads = value_and_grad(loss_fn, params, local)
        dist.all_reduce(loss, group=group)
        loss = loss / n
        grads, err_state = homa_allreduce(grads, group, cfg, err_state)
        params, opt_state, metrics = opt_update(params, grads, opt_state)
        metrics = {**metrics, "loss": loss}
        if err_state is None:
            err_state = torch.zeros((), dtype=F32, device=loss.device)
        return params, opt_state, metrics, err_state

    return step


def init_err_state(params, cfg: SyncConfig):
    if cfg.compress and cfg.error_feedback:
        return tree_map(lambda p: torch.zeros((p.numel(),), dtype=F32,
                                              device=p.device), params)
    return torch.zeros((), dtype=F32,
                       device=flatten(params)[0].device)
