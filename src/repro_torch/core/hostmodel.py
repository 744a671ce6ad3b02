"""Pluggable host/NIC stage: per-packet software overhead (DESIGN.md §10);
the port of ``repro.core.hostmodel``.

Homa's §5.3 reports a large gap between implementation and simulation
latency, most of it host software cost that a fabric-only simulator
models as zero. This stage adds that cost in front of the network, on
both sides of the wire:

  send side     a per-host TX token bucket in fixed-point "micro-slots"
                (1/256 slot): every transmitted chunk charges
                ``tx_cost_slots`` of CPU time, every ``tx_batch``-th
                chunk additionally pays ``tx_batch_cost_slots``, and
                budget accrues while idle up to ``tx_queue_cap`` chunks'
                worth, so bursts go out at line rate but the sustained
                rate is 1/cost chunks per slot.
  receive side  a per-host bounded FIFO (NIC RX ring): each chunk
                drained off the downlink enters the ring and becomes
                visible to the receiver (``recv``, which clocks both
                grants and completion) only after ``rx_cost_slots`` of
                serialized CPU service; a full ring backpressures the
                downlink (the chunk stays queued in the network).

Everything is int32 fixed point: ``prepare`` bounds ``max_slots`` below
2**21, so absolute micro-slot timestamps (``now * QSCALE``) stay under
2**29.

``SimConfig.host=None`` and the ``ideal`` preset (all costs zero) add no
tensors and no operations to the slot loop, so the goldens stay
bit-identical; a side whose costs are all zero (``tx_on`` / ``rx_on``
False) vanishes the same way.

Every hook works on the run axis of the port's state: ``(B, H)`` per-host
tensors and ``(B, H, cap)`` for the RX ring. Host models are pluggable:
implement :class:`HostModel`'s five hooks and :func:`register_host_model`
an instance; ``HostConfig.model`` selects it by name. ``"cpu"``
(:class:`CpuHostModel`) ships with the presets

  ideal          zero overhead: the stage is skipped
  kernel_stack   OS kernel networking: 1 slot a chunk of TX cost plus an
                 8-slot interrupt batch every 8 chunks, 2 slots RX
                 service
  kernel_bypass  DPDK-style polling: 0.25 slots TX, 0.5 slots RX
"""
from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.core.protocols import I32
from repro_torch.core.scatter import set_drop

# fixed-point scale: micro-slots per link slot (8 fractional bits)
QSCALE = 256


@dataclasses.dataclass(frozen=True)
class HostConfig:
    """Host/NIC stage parameters (frozen, hashable).

    Costs are in link-slot units (1 slot = ``slot_bytes`` of wire time)
    and quantized to 1/256 slot.
    """
    model: str = "cpu"              # registered HostModel implementation
    tx_cost_slots: float = 0.0      # CPU time per transmitted chunk
    tx_batch: int = 1               # chunks per interrupt/doorbell batch
    tx_batch_cost_slots: float = 0.0  # extra cost on each batch boundary
    tx_queue_cap: int = 1           # TX ring depth (chunks): idle accrual
    rx_cost_slots: float = 0.0      # serialized CPU time per received chunk
    rx_queue_cap: int = 64          # RX ring depth; full -> downlink stalls

    def validate(self) -> None:
        get_host_model(self.model)          # ValueError on unknown model
        for f in ("tx_cost_slots", "tx_batch_cost_slots", "rx_cost_slots"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 4096.0:
                raise ValueError(f"HostConfig.{f}={v!r} must be in "
                                 f"[0, 4096] slots")
        for f in ("tx_batch", "tx_queue_cap", "rx_queue_cap"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"HostConfig.{f}={v!r} must be an int >= 1")

    # -- fixed-point views (Python's round: half to even, as the JAX
    # package rounds) -----------------------------------------------------
    @property
    def tx_cost_q(self) -> int:
        return int(round(self.tx_cost_slots * QSCALE))

    @property
    def tx_batch_cost_q(self) -> int:
        return int(round(self.tx_batch_cost_slots * QSCALE))

    @property
    def rx_cost_q(self) -> int:
        return int(round(self.rx_cost_slots * QSCALE))

    @property
    def tx_burst_q(self) -> int:
        """Token-bucket cap: ``tx_queue_cap`` chunks' worth of budget
        (never below the worst single-chunk charge, so no config can
        deadlock the gate)."""
        return max(self.tx_queue_cap * max(self.tx_cost_q, QSCALE),
                   self.tx_cost_q + self.tx_batch_cost_q)

    # -- structural gates --------------------------------------------------
    @property
    def tx_on(self) -> bool:
        return self.tx_cost_q > 0 or self.tx_batch_cost_q > 0

    @property
    def rx_on(self) -> bool:
        return self.rx_cost_q > 0

    @property
    def is_ideal(self) -> bool:
        """All costs zero: the stage is skipped and the loop is
        bit-identical to ``host=None``."""
        return not (self.tx_on or self.rx_on)


class HostModel(abc.ABC):
    """Enforced interface for a host/NIC stage implementation.

    ``step_fn`` talks to the host model only through these five hooks.
    All hooks are pure: state in, state out, tensors only, each with the
    leading run axis B of the port's state; none may read a value back
    to the host."""
    name: str = "base"

    @abc.abstractmethod
    def init_state(self, cfg, M: int, B: int = 1) -> dict:
        """Slot-0 state tensors of B runs (prefix ``h_``), keyed off
        ``cfg.host``."""

    @abc.abstractmethod
    def host_tx(self, cfg, st, want, now):
        """Gate this slot's transmissions on TX CPU availability.

        ``want``: (B, H) bool, hosts with a sendable chunk selected.
        Returns ``(sent, st)``: the gated (B, H) mask of hosts that may
        put their chunk on the wire this slot, and the updated state."""

    @abc.abstractmethod
    def rx_deliver(self, cfg, st, S, now) -> dict:
        """Complete RX processing: move every ring entry whose service
        finished by ``now`` into ``st['recv']`` (at most one per host
        per slot)."""

    @abc.abstractmethod
    def rx_room(self, cfg, st):
        """(B, H) bool: hosts whose RX ring can accept a chunk this slot;
        False backpressures the downlink (the chunk stays queued)."""

    @abc.abstractmethod
    def rx_accept(self, cfg, st, S, msg, ok, now) -> dict:
        """Enqueue this slot's drained chunk (per host, masked by
        ``ok``) into the RX ring with its service-completion time."""


_HOST_MODELS: dict[str, HostModel] = {}


def register_host_model(model: HostModel) -> HostModel:
    """Register a :class:`HostModel` instance under ``model.name``. The
    abc machinery enforces the interface: a subclass missing any hook
    cannot be instantiated."""
    if not isinstance(model, HostModel):
        raise TypeError(f"register_host_model expects a HostModel "
                        f"instance, got {type(model).__name__}")
    _HOST_MODELS[model.name] = model
    return model


def get_host_model(name: str) -> HostModel:
    try:
        return _HOST_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown host model {name!r}; registered: "
                         f"{sorted(_HOST_MODELS)}") from None


class CpuHostModel(HostModel):
    """TX token bucket + bounded RX service FIFO (module docstring)."""
    name = "cpu"

    def init_state(self, cfg, M: int, B: int = 1) -> dict:
        hc = cfg.host
        H, dev = cfg.n_hosts, cfg.device

        def z(*shape, dtype=I32):
            return torch.zeros((B, *shape), dtype=dtype, device=dev)

        st = {}
        if hc.tx_on:
            st.update({
                # bucket starts full: a cold host bursts its TX ring depth
                "h_tx_budget_q": torch.full((B, H), hc.tx_burst_q,
                                            dtype=I32, device=dev),
                "h_tx_work_q": z(H),       # spent CPU micro-slots
                "h_tx_defer": z(H),        # slots gated with traffic
            })
            if hc.tx_batch > 1:
                st["h_tx_cnt"] = z(H)      # chunks into the batch
        if hc.rx_on:
            cap = hc.rx_queue_cap
            st.update({
                "h_rx_msg": torch.full((B, H, cap), -1, dtype=I32,
                                       device=dev),
                "h_rx_ready_q": z(H, cap),     # absolute micro-slots
                "h_rx_head": z(H),
                "h_rx_tail": z(H),
                "h_rx_busy_q": z(H),           # CPU busy-until
                "h_rx_stall": z(H),            # slots downlink blocked
                "h_rx_q_sum": z(H, dtype=torch.float32),
                "h_rx_q_max": z(H),
            })
        return st

    def host_tx(self, cfg, st, want, now):
        hc = cfg.host
        budget = (st["h_tx_budget_q"] + QSCALE).clamp_max(hc.tx_burst_q)
        if hc.tx_batch > 1:
            boundary = st["h_tx_cnt"] + 1 >= hc.tx_batch
            # tx_cost_q, plus tx_batch_cost_q on a batch boundary
            charge = hc.tx_cost_q + boundary.to(I32) * hc.tx_batch_cost_q
        else:
            charge = hc.tx_cost_q + hc.tx_batch_cost_q
        ok = budget >= charge
        sent = want & ok
        spend = sent.to(I32) * charge
        st = {**st, "h_tx_budget_q": budget - spend,
              "h_tx_work_q": st["h_tx_work_q"] + spend,
              "h_tx_defer": st["h_tx_defer"] + (want & ~ok).to(I32)}
        if hc.tx_batch > 1:
            cnt = st["h_tx_cnt"]
            st["h_tx_cnt"] = torch.where(
                sent, torch.where(boundary, 0, cnt + 1), cnt)
        return sent, st

    def rx_deliver(self, cfg, st, S, now):
        cap = cfg.host.rx_queue_cap
        M = S["size"].shape[1]
        head, tail = st["h_rx_head"], st["h_rx_tail"]
        occ = tail - head
        hpos = (head % cap).long()[..., None]                 # (B, H, 1)
        ready = st["h_rx_ready_q"].gather(2, hpos)[..., 0]
        can = (occ > 0) & (ready <= now * QSCALE)
        msg = st["h_rx_msg"].gather(2, hpos)[..., 0]
        # a host that delivers nothing adds 0 at a clamped index
        recv = st["recv"].scatter_add(1, msg.clamp(0, M - 1).long(),
                                      can.to(I32))
        return {**st, "recv": recv, "h_rx_head": head + can.to(I32),
                "h_rx_q_sum": st["h_rx_q_sum"] + occ.to(torch.float32),
                "h_rx_q_max": torch.maximum(st["h_rx_q_max"], occ)}

    def rx_room(self, cfg, st):
        return (st["h_rx_tail"] - st["h_rx_head"]) < cfg.host.rx_queue_cap

    def rx_accept(self, cfg, st, S, msg, ok, now):
        hc = cfg.host
        cap = hc.rx_queue_cap
        tail = st["h_rx_tail"]
        # serialized service: this chunk is processed after everything
        # already in the ring, never before its own arrival slot ends
        ready = torch.maximum(st["h_rx_busy_q"], now * QSCALE) \
            + hc.rx_cost_q
        # flat index of ring slot (h, tail % cap); a host that accepts
        # nothing writes nowhere (set_drop), never over a live entry
        hh = torch.arange(cfg.n_hosts, dtype=I32, device=tail.device)
        idx = hh * cap + tail % cap
        return {**st,
                "h_rx_msg": set_drop(st["h_rx_msg"], idx, msg, ok),
                "h_rx_ready_q": set_drop(st["h_rx_ready_q"], idx, ready,
                                         ok),
                "h_rx_tail": tail + ok.to(I32),
                "h_rx_busy_q": torch.where(ok, ready, st["h_rx_busy_q"])}


register_host_model(CpuHostModel())


HOST_PRESETS: dict[str, HostConfig] = {
    "ideal": HostConfig(),
    "kernel_stack": HostConfig(tx_cost_slots=1.0, tx_batch=8,
                               tx_batch_cost_slots=8.0, tx_queue_cap=16,
                               rx_cost_slots=2.0, rx_queue_cap=256),
    "kernel_bypass": HostConfig(tx_cost_slots=0.25, tx_queue_cap=32,
                                rx_cost_slots=0.5, rx_queue_cap=64),
}


def host_preset(name: str) -> HostConfig:
    try:
        return HOST_PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown host preset {name!r}; available: "
                         f"{sorted(HOST_PRESETS)}") from None


def as_host_config(host) -> HostConfig | None:
    """Normalize ``SimConfig.host``: HostConfig | preset name | dict | None."""
    if host is None or isinstance(host, HostConfig):
        return host
    if isinstance(host, str):
        return host_preset(host)
    if isinstance(host, dict):
        return HostConfig(**host)
    raise TypeError(f"SimConfig.host must be a HostConfig, preset name, "
                    f"dict, or None — got {type(host).__name__}")


__all__ = ["HostConfig", "HostModel", "CpuHostModel", "HOST_PRESETS",
           "host_preset", "as_host_config", "register_host_model",
           "get_host_model", "QSCALE"]
