"""Transport protocols as composable policies (DESIGN.md §1), in PyTorch.

The port of ``repro.core.protocols``: the same six policies (homa, basic,
phost, pias, pfabric, ndp), the same registry and the same int32 key
packing, so every slot computes what the JAX package computes, bit for
bit. Policies are plain functions of tensors; ``cfg.device`` places the
state they create and ``cfg.backend`` routes the grant top-K to the
hand-written CUDA kernels or their plain versions (``kernels.arbiter``).

Every tensor carries a leading run axis B: per-message arrays are
``(B, M)``, per-host ``(B, H)``, and run b is an independent copy of the
JAX package's single run. ``cm`` (each host's chosen message) is a
``(B, H)`` int64 index, so policies gather with it directly.

  ``SenderPolicy``    which message each host transmits next and the
                      priority stamped on the outgoing chunk.
  ``ReceiverPolicy``  which messages are granted this slot, the scheduled
                      priority of each, and the overcommitment degree.
  ``Protocol``        one named sender+receiver pair plus static per-message
                      preparation and optional per-slot hooks.

Out-of-range scatters of the JAX package (``mode="drop"``) go through
:mod:`repro_torch.core.scatter`, which masks them instead of clamping.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.scatter import amax_drop, last_writer, set_drop
from repro_torch.kernels.arbiter import dispatch

I32 = torch.int32
BIG = 2 ** 30
MSG_BITS = 13
MSG_MOD = 1 << MSG_BITS          # max messages per sim
ORDER_CAP = (1 << 17) - 1        # sender-order keys clamp here


# --------------------------------------------------------------- senders ---

@dataclasses.dataclass(frozen=True)
class SenderPolicy:
    """Chunk selection order + priority stamping at the sending host."""

    def order(self, cfg, st, S, now, remaining):
        """(B, M) int32 key; per host, the sendable message with the
        smallest key transmits this slot (ties break toward the smallest
        msg id)."""
        raise NotImplementedError

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        """(B, H) int32 wire priority for each host's chosen chunk (smaller
        = served first), honoured by every queueing tier the chunk crosses.
        ``cm`` is the chosen message per host (clamped, int64), ``unsched``
        marks chunks inside the blind window."""
        raise NotImplementedError

    def on_send(self, cfg, st, S, cm, has, now):
        """Post-transmit bookkeeping hook (default: none)."""
        return st


@dataclasses.dataclass(frozen=True)
class SrptSender(SenderPolicy):
    """Shortest-remaining-processing-time chunk order (paper §3.2)."""

    def order(self, cfg, st, S, now, remaining):
        return remaining.clamp_max(ORDER_CAP)


@dataclasses.dataclass(frozen=True)
class FifoSender(SenderPolicy):
    """Arrival-order senders (NDP's per-message FIFO pull queues)."""

    def order(self, cfg, st, S, now, remaining):
        return S["arrival"].clamp_max(ORDER_CAP)


@dataclasses.dataclass(frozen=True)
class FairShareSender(SenderPolicy):
    """Least-recently-served round robin (DCTCP-style fair sharing)."""

    def order(self, cfg, st, S, now, remaining):
        return st["last_sent"].clamp_max(ORDER_CAP)

    def on_send(self, cfg, st, S, cm, has, now):
        # hosts that send nothing write back the old value at their clamped
        # index; the last write to an index wins, as in the JAX scatter
        vals = torch.where(has, now, st["last_sent"].gather(1, cm))
        return {**st, "last_sent": set_drop(st["last_sent"], cm, vals,
                                            last_writer(cm))}


# ------------------------------------------------------------- receivers ---

@dataclasses.dataclass(frozen=True)
class ReceiverPolicy:
    """Grant issue + scheduled-priority assignment + overcommit degree."""

    def grants(self, cfg, st, S, now, n_sched, topk=None):
        """Returns ``(grant_r, sched_prio, active, withheld)``: (B, M)
        granted slots, (B, M) scheduled priority, (B, M) bool mask of
        messages the receivers actively schedule, and (B, H) bool — hosts
        with known-but-ungranted traffic (wasted-bandwidth accounting).

        ``topk`` is the precomputed ``(vals, idx)`` answer to this
        policy's :meth:`grant_problem` — supplied by the ``fused``
        backend, which solves it inside the fused per-slot kernel
        (DESIGN.md §11). Policies without a grant problem ignore it."""
        raise NotImplementedError

    def grant_problem(self, cfg, st, S, now, n_sched):
        """The top-K selection this policy would issue this slot, as
        ``(keys (B, H, M), K)`` for the fused kernel — or ``None`` if the
        policy selects no grant set (window receivers). Must read exactly
        the state :meth:`grants` reads, so solving it at slot start is
        bit-identical to solving it inside :meth:`grants`."""
        return None

    def resend(self, cfg, st, S, now, known, quiet):
        """Receiver-side loss detection (paper §3.7): (B, M) bool mask of
        messages whose sender should rewind to the receiver's high-water
        mark this slot. ``known`` marks messages the receiver has heard
        from (recv > 0); ``quiet`` is slots since the last chunk arrival
        (or rewind). Only called on fault-enabled fabrics; the default
        leaves recovery to the sender fallback timeout — the honest model
        for window baselines with no receiver scheduler."""
        return torch.zeros_like(known)


def window_grants(cfg, st, S, gate):
    """Keep ``gate``-ed messages granted one RTT of data beyond what was
    received (classic receive-window clocking)."""
    grant_r = torch.where(gate,
                          torch.minimum(S["size"],
                                        st["recv"] + cfg.rtt_slots),
                          st["grant_r"])
    grant_r = torch.maximum(grant_r, st["grant_r"])
    no_withheld = torch.zeros((gate.shape[0], cfg.n_hosts),
                              dtype=torch.bool, device=gate.device)
    return grant_r, torch.zeros_like(st["sched_prio"]), gate, no_withheld


def srpt_grant_matrix(cfg, st, S, eligible, K):
    """The receiver-side SRPT selection problem as a dense key matrix:
    ``(keys (B, H, M), K)`` where row h of run b holds the grant key of
    every message destined to host h (0 = ineligible) and K is clamped to
    M. The kernels see it as ``B * H`` rows (staged) or as ``(B, H, M)``
    (fused).

    The key orders by (remaining, msg): smaller remaining wins, ties break
    toward the SMALLEST msg id. A stable active set is what gives SRPT its
    run-to-completion behaviour — an unstable tie-break churns the active
    message and leaks grants to every tied message (catastrophic under
    incast, where all messages are the same size)."""
    size, dst_oh = S["size"], S["dst_onehot"]
    remaining = (size - st["recv"]).clamp_min(0)
    K = min(K, size.shape[1])        # can't select more than M messages
    keyval = (((1 << 17) - remaining.clamp_max((1 << 17) - 1)) << MSG_BITS) \
        | (MSG_MOD - 1 - S["msg_ids"])
    mat = torch.where(dst_oh & eligible[:, None, :], keyval[:, None, :], 0)
    return mat, K


def topk_srpt_grants(cfg, st, S, eligible, K, n_sched, topk=None):
    """Each receiver grants its top-K SRPT messages one RTT ahead and
    assigns scheduled priorities lowest-levels-first (paper §3.4/Fig. 5),
    shortest message on the highest scheduled level. The top-K is the
    ``srpt_topk`` kernel on ``backend="cuda"`` (all runs' rows in one
    launch); its index output IS the winning message id (columns of the
    key matrix). The ``fused`` backend passes the selection in pre-solved
    (``topk=(vals, idx)``, from the fused slot kernel — DESIGN.md §11)."""
    size, dst_oh = S["size"], S["dst_onehot"]
    B, M = size.shape
    if topk is None:
        mat, K = srpt_grant_matrix(cfg, st, S, eligible, K)
        H = mat.shape[1]
        vals, idx = dispatch.topk(mat.view(B * H, M), K,
                                  backend=cfg.backend)
        vals, idx = vals.view(B, H, K), idx.view(B, H, K)
    else:
        vals, idx = topk
        K = vals.shape[-1]
    valid = vals > 0
    n_active = valid.sum(dim=2, dtype=I32)                        # (B, H)
    # scheduled priority: rank r (0 = fewest remaining) among A active gets
    # level (A-1-r): lowest levels used first, shortest on top (paper §3.4)
    ranks = torch.arange(K, dtype=I32, device=vals.device)
    prio = (n_active[:, :, None] - 1 - ranks).clamp(0, max(n_sched - 1, 0))

    # invalid entries are the JAX package's MSG_MOD sentinel, dropped
    flat_msgs, flat_valid = idx.reshape(B, -1), valid.reshape(B, -1)
    new_grant = torch.minimum(size, st["recv"] + cfg.rtt_slots)
    grant_r = amax_drop(
        st["grant_r"], flat_msgs,
        torch.where(flat_valid,
                    new_grant.gather(1, flat_msgs.clamp(0, M - 1).long()),
                    0),
        flat_valid)
    sched_prio = set_drop(st["sched_prio"], flat_msgs, prio.reshape(B, -1),
                          flat_valid)
    active = set_drop(torch.zeros_like(eligible), flat_msgs, flat_valid,
                      flat_valid)
    withheld = (dst_oh & (eligible & ~active)[:, None, :]).any(dim=2)
    return grant_r, sched_prio, active, withheld


def grant_preempted(prev_active, active, completion):
    """(B, M) bool: messages evicted from the receiver's active grant set
    this slot while still incomplete, i.e. preempted for shorter messages
    under SRPT overcommitment (paper §3.5), not retired by completion.
    Used by the telemetry event ledger."""
    return prev_active & ~active & (completion < 0)


@dataclasses.dataclass(frozen=True)
class WindowReceiver(ReceiverPolicy):
    """RTT-window grants to every known (``blind=False``) or merely arrived
    (``blind=True``) incomplete message; no receiver-side scheduling."""
    blind: bool = False

    def grants(self, cfg, st, S, now, n_sched, topk=None):
        if self.blind:
            gate = (S["arrival"] <= now) & (st["completion"] < 0)
        else:
            gate = (st["recv"] > 0) & (st["completion"] < 0)
        return window_grants(cfg, st, S, gate)


@dataclasses.dataclass(frozen=True)
class OvercommitSrptReceiver(ReceiverPolicy):
    """Homa's receiver: top-K SRPT with controlled overcommitment
    (paper §3.5). K defaults to the number of scheduled priority levels;
    ``cfg.overcommit`` overrides it. ``max_k=1`` models single-grant
    receivers (pHost); ``stall_aware`` honours the sender-timeout
    blacklist maintained by :class:`Phost.post_step`."""
    max_k: int | None = None
    stall_aware: bool = False

    def _k(self, cfg, n_sched):
        if self.max_k is not None:
            return self.max_k
        return cfg.overcommit or max(n_sched, 1)

    def _eligible(self, cfg, st, now):
        eligible = (st["recv"] > 0) & (st["completion"] < 0)
        if self.stall_aware:
            eligible = eligible & (st["stall_until"] <= now)
        return eligible

    def grants(self, cfg, st, S, now, n_sched, topk=None):
        return topk_srpt_grants(cfg, st, S, self._eligible(cfg, st, now),
                                self._k(cfg, n_sched), n_sched, topk=topk)

    def grant_problem(self, cfg, st, S, now, n_sched):
        return srpt_grant_matrix(cfg, st, S, self._eligible(cfg, st, now),
                                 self._k(cfg, n_sched))

    def resend(self, cfg, st, S, now, known, quiet):
        # Homa's receiver timeout (paper §3.7): a receiver that actively
        # schedules its inbound messages RESENDs any known message quiet
        # for resend_slots, well before the sender fallback fires
        return known & (quiet >= cfg.fabric.faults.resend_slots)


# ------------------------------------------------------------- protocols ---

@dataclasses.dataclass(frozen=True)
class Protocol:
    """One named transport protocol = sender policy + receiver policy +
    static per-message preparation + optional per-slot hooks."""
    name: str = ""
    sender: SenderPolicy = dataclasses.field(default_factory=SrptSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=WindowReceiver)

    # ---- static preparation (numpy, once per table) ----

    def unsched_limit(self, cfg, M, unsched_limit_bytes):
        """Per-message unscheduled (blind) byte budget."""
        if unsched_limit_bytes is None:
            unsched_limit_bytes = cfg.rtt_bytes
        return np.broadcast_to(np.asarray(unsched_limit_bytes), (M,))

    def unsched_prio(self, cfg, sizes, alloc):
        """Per-message priority level for unscheduled chunks."""
        return np.zeros((len(sizes),))

    def n_sched(self, cfg, alloc):
        """Number of scheduled priority levels (static loop parameter)."""
        return max(cfg.overcommit or alloc.n_sched, 1)

    def extra_state(self, cfg, M, B):
        """Protocol-private loop state of B runs — only the protocols that
        need an array pay for carrying it."""
        return {}

    # ---- per-slot hooks ----

    def on_drain(self, cfg, st, S, drained_msg, any_elig, now):
        """Called after the downlink drains a chunk; returns updated state."""
        return st

    def post_step(self, cfg, st, S, now, active, drained_msg, any_elig):
        """End-of-slot hook (e.g. timeout bookkeeping); returns state."""
        return st


def _zeros_m(cfg, M, B):
    return torch.zeros((B, M), dtype=I32, device=cfg.device)


@dataclasses.dataclass(frozen=True)
class ConstPrioSender(SrptSender):
    """SRPT order, all chunks on one fixed priority level."""
    level: int = 0

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        return torch.full_like(cm, self.level, dtype=I32)


@dataclasses.dataclass(frozen=True)
class NdpSender(FifoSender):
    """FIFO order; unscheduled chunks above scheduled, two static levels."""

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        return (~unsched).to(I32)


@dataclasses.dataclass(frozen=True)
class HomaSender(SrptSender):
    """Receiver-allocated priorities (paper §3.4): unscheduled levels from
    the workload CDF, scheduled levels from the grant's priority field."""

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        up = cfg.n_prios - 1 - S["uprio"].gather(1, cm)  # smaller = better
        sp = n_sched - 1 - st["sched_prio"].gather(1, cm)  # scheduled band
        sched_inv = (cfg.n_prios - n_sched) + sp    # scheduled below unsched
        # unscheduled levels sit above (smaller inv value) all scheduled
        return torch.where(unsched, up, sched_inv)


@dataclasses.dataclass(frozen=True)
class Homa(Protocol):
    name: str = "homa"
    sender: SenderPolicy = dataclasses.field(default_factory=HomaSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=OvercommitSrptReceiver)

    def unsched_prio(self, cfg, sizes, alloc):
        return alloc.unsched_prio(sizes)

    def n_sched(self, cfg, alloc):
        return max(alloc.n_sched, 1)


@dataclasses.dataclass(frozen=True)
class Basic(Protocol):
    """Receiver-window transport with no priorities (the paper's 'basic'
    receiver-driven baseline)."""
    name: str = "basic"
    sender: SenderPolicy = dataclasses.field(default_factory=ConstPrioSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=WindowReceiver)


@dataclasses.dataclass(frozen=True)
class PhostTwoLevelSender(SrptSender):
    """SRPT order; RTS/unscheduled packets above scheduled data."""

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        return (~unsched).to(I32)


@dataclasses.dataclass(frozen=True)
class Phost(Protocol):
    """pHost: single-message grants (token per RTT, K=1) with a sender
    timeout that blacklists unresponsive messages (DESIGN.md §3)."""
    name: str = "phost"
    sender: SenderPolicy = dataclasses.field(
        default_factory=PhostTwoLevelSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=lambda: OvercommitSrptReceiver(max_k=1,
                                                       stall_aware=True))

    def unsched_prio(self, cfg, sizes, alloc):
        return np.full((len(sizes),), cfg.n_prios - 1)

    def extra_state(self, cfg, M, B):
        return {"stall_until": _zeros_m(cfg, M, B),    # timeout blacklist
                "last_progress": _zeros_m(cfg, M, B)}

    def post_step(self, cfg, st, S, now, active, drained_msg, any_elig):
        # if the single granted message makes no progress for `timeout`
        # slots, blacklist it briefly so the receiver switches to another
        # message (approximates pHost's sender-timeout mechanism).
        M = S["size"].shape[1]
        lp = torch.maximum(st["last_progress"], S["arrival"])
        lp = lp.scatter_reduce(1, drained_msg.clamp_max(M - 1).long(),
                               torch.where(any_elig, now, 0), "amax",
                               include_self=True)
        timed_out = active & (st["grant_r"] > st["recv"]) & \
            (now - lp > cfg.phost_timeout_slots)
        new_stall = torch.where(timed_out, now + cfg.phost_timeout_slots,
                                st["stall_until"])
        return {**st, "stall_until": new_stall, "last_progress": lp}


@dataclasses.dataclass(frozen=True)
class PiasSender(FairShareSender):
    """MLFQ: chunks demote to lower levels as the flow's sent bytes cross
    the precomputed thresholds (level 0 first, demoted upward)."""

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        return torch.searchsorted(S["pias_cuts"], st["sent"].gather(1, cm),
                                  right=True, out_int32=True)


@dataclasses.dataclass(frozen=True)
class Pias(Protocol):
    name: str = "pias"
    sender: SenderPolicy = dataclasses.field(default_factory=PiasSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=lambda: WindowReceiver(blind=True))

    def extra_state(self, cfg, M, B):
        return {"last_sent": _zeros_m(cfg, M, B)}     # round-robin clock

    def unsched_limit(self, cfg, M, unsched_limit_bytes):
        return np.full((M,), cfg.rtt_bytes)          # blind first window


@dataclasses.dataclass(frozen=True)
class PfabricSender(SrptSender):
    """Continuous priority = remaining slots (pFabric's ideal SRPT wire)."""

    def chunk_prio(self, cfg, st, S, cm, unsched, n_sched):
        return (S["size"].gather(1, cm)
                - st["sent"].gather(1, cm)).clamp_min(0)


@dataclasses.dataclass(frozen=True)
class Pfabric(Protocol):
    name: str = "pfabric"
    sender: SenderPolicy = dataclasses.field(default_factory=PfabricSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=lambda: WindowReceiver(blind=True))

    def unsched_limit(self, cfg, M, unsched_limit_bytes):
        return np.full((M,), cfg.rtt_bytes)          # blind first window


@dataclasses.dataclass(frozen=True)
class Ndp(Protocol):
    """NDP: FIFO pull queues per receiver, two static priority levels
    (header/retransmit above bulk), per-message round-robin service."""
    name: str = "ndp"
    sender: SenderPolicy = dataclasses.field(default_factory=NdpSender)
    receiver: ReceiverPolicy = dataclasses.field(
        default_factory=WindowReceiver)

    def unsched_prio(self, cfg, sizes, alloc):
        return np.full((len(sizes),), cfg.n_prios - 1)

    def extra_state(self, cfg, M, B):
        return {"last_served": _zeros_m(cfg, M, B)}   # fair-share clock

    def on_drain(self, cfg, st, S, drained_msg, any_elig, now):
        # as in the JAX package, a host that drained nothing (drained_msg
        # == M) still stamps message M-1; every write is `now`, so the
        # order of duplicate writes cannot matter
        M = S["size"].shape[1]
        ls = st["last_served"].scatter(
            1, drained_msg.clamp_max(M - 1).long(),
            now.expand(drained_msg.shape))
        return {**st, "last_served": ls}


# --------------------------------------------------------------- registry ---

_REGISTRY: dict[str, Protocol] = {}


def register(proto: Protocol) -> Protocol:
    """Register a protocol under ``proto.name`` (overwrites silently so a
    variant can shadow a builtin during experiments)."""
    if not proto.name:
        raise ValueError("protocol needs a non-empty name")
    _REGISTRY[proto.name] = proto
    return proto


def registered_protocols() -> list[str]:
    return sorted(_REGISTRY)


def get_protocol(name: str) -> Protocol:
    """Look up a registered protocol; unknown names raise ``ValueError``
    listing what is available."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol {name!r}; registered protocols: "
            f"{registered_protocols()}") from None


for _p in (Homa(), Basic(), Phost(), Pias(), Pfabric(), Ndp()):
    register(_p)
