"""Data pipeline: deterministic-by-step sharded batches with background
prefetch. A copy of the JAX package's ``data/pipeline.py`` (pure numpy),
kept so that the port imports nothing of ``repro``: the same
``DataConfig`` gives the same batches, bit for bit. Batches are numpy
arrays; the driver moves them to the device.

Determinism is the straggler/fault story (DESIGN.md §3): batch(step, host) is
a pure function of (seed, step, host), so any host can recompute any shard
after a restart without coordination, and restarts resume mid-epoch exactly.

Two sources:
- SyntheticLM: endless token stream from a seeded generator (a fixed
  synthetic "language" with Zipfian unigrams + local structure, so models
  actually learn and loss curves are meaningful).
- MemmapCorpus: flat uint16/uint32 token file, random crops per step.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Zipf unigrams + order-2 structure: token ~ f(prev, latent topic)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # deterministic "grammar": each token has a preferred successor band
        self.shift = rng.integers(1, max(V // 4, 2), size=V)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self.unigram)
        mix = rng.random((B, S))
        noise = rng.choice(V, size=(B, S), p=self.unigram)
        for t in range(S):
            succ = (toks[:, t] + self.shift[toks[:, t]]) % V
            toks[:, t + 1] = np.where(mix[:, t] < 0.65, succ, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class MemmapCorpus:
    def __init__(self, cfg: DataConfig, path: str | Path,
                 dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        assert len(self.data) > cfg.seq_len + 1

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        B, S = cfg.host_batch, cfg.seq_len
        starts = rng.integers(0, len(self.data) - S - 1, size=B)
        toks = np.stack([self.data[s:s + S + 1] for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class Prefetcher:
    """Background-thread prefetch of future steps (bounded queue)."""

    def __init__(self, source, start_step: int, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self._step
        while not self._stop.is_set():
            b = self.source.batch(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.2)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
