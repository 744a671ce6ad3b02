"""Homa-SRPT serving scheduler: an inference server is a Homa receiver
(DESIGN.md §2.2) — many clients contend for its decode slots.

The port of the JAX package's ``serving/scheduler.py``, line for line
(numpy and the standard library; no tensor code).

Mapping of the paper's mechanisms:

  blind/unscheduled (§2.2)   requests with a small remaining-token budget
                             (<= unsched_limit) skip the admission queue
  grants (§3.3)              admission of queued requests, issued in SRPT
                             order as slots free up
  dynamic priorities (§3.4)  priority classes from equal-work cutoffs over
                             the observed request-size distribution (Fig. 4's
                             algorithm, recomputed online — beyond-paper: the
                             paper's impl precomputes from workload knowledge)
  overcommitment (§3.5)      K extra requests are admitted beyond the decode
                             batch so a stalled/finished slot is refilled
                             without a scheduling round-trip
  SRPT run-to-completion     each step serves the batch_size best
                             (priority, remaining) requests
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.core.priorities import equal_bytes_cutoffs


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float
    generated: int = 0
    done: bool = False
    first_token_time: float | None = None
    finish_time: float | None = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - self.generated


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    batch_size: int = 8           # decode slots (the "downlink")
    overcommit: int = 7           # K extra admitted (paper: #sched prios)
    n_prios: int = 8
    unsched_limit: int = 32       # remaining <= this skips the queue
    history: int = 512            # sliding window for cutoff estimation
    srpt: bool = True             # False -> FIFO (the "Basic" ablation)


class HomaScheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.queue: deque[Request] = deque()     # awaiting admission
        self.active: list[Request] = []          # admitted ("granted")
        self.finished: list[Request] = []
        self.size_history: deque[int] = deque(maxlen=cfg.history)
        self.cutoffs: list[int] = []

    # ------------------------------------------------------------ intake ---
    def submit(self, req: Request):
        self.size_history.append(req.max_new_tokens)
        self._refresh_cutoffs()
        if req.remaining <= self.cfg.unsched_limit:
            self.active.append(req)              # unscheduled fast path
        else:
            self.queue.append(req)
        self._admit()

    def _refresh_cutoffs(self):
        if len(self.size_history) >= 8:
            sizes = np.asarray(self.size_history)
            self.cutoffs = equal_bytes_cutoffs(
                sizes, sizes.astype(np.float64), self.cfg.n_prios)

    def priority(self, req: Request) -> int:
        """Higher value = served later (0 is best), from dynamic cutoffs."""
        if not self.cutoffs:
            return 0
        return int(np.searchsorted(self.cutoffs, req.remaining))

    def _admit(self):
        """Grant admission up to batch_size + overcommit active requests,
        SRPT order (the paper's top-K grant set)."""
        limit = self.cfg.batch_size + self.cfg.overcommit
        if self.cfg.srpt:
            q = sorted(self.queue, key=lambda r: (r.remaining, r.arrival))
        else:
            q = sorted(self.queue, key=lambda r: r.arrival)
        while len(self.active) < limit and q:
            r = q.pop(0)
            self.queue.remove(r)
            self.active.append(r)

    # ------------------------------------------------------------- serve ---
    def select_batch(self) -> list[Request]:
        """The batch_size best (priority, remaining) active requests."""
        live = [r for r in self.active if not r.done]
        key = (lambda r: (self.priority(r), r.remaining, r.arrival)) \
            if self.cfg.srpt else (lambda r: r.arrival)
        live.sort(key=key)
        return live[: self.cfg.batch_size]

    def step(self, decode_fn: Callable[[list[Request]], list[bool]],
             now: float) -> list[Request]:
        """One decode step: serve the selected batch, retire finished
        requests, refill from the admission queue. Returns retirees."""
        batch = self.select_batch()
        if not batch:
            self._admit()
            return []
        done_flags = decode_fn(batch)
        retired = []
        for r, d in zip(batch, done_flags):
            r.generated += 1
            if r.first_token_time is None:
                r.first_token_time = now
            if d or r.remaining <= 0:
                r.done = True
                r.finish_time = now
                retired.append(r)
        self.active = [r for r in self.active if not r.done]
        self.finished.extend(retired)
        self._admit()
        return retired

    # ------------------------------------------------------------- stats ---
    def slowdowns(self) -> np.ndarray:
        out = []
        for r in self.finished:
            ideal = max(r.max_new_tokens, 1)
            out.append((r.finish_time - r.arrival) / ideal)
        return np.asarray(out)
