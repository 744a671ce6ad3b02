"""Slotted packet-level datacenter network simulator, in PyTorch.

The port of ``repro.core.sim``: the same slots, policies and state as
the JAX package's ``lax.scan``, run as a Python loop of tensor
operations on one device (a CUDA card unless the caller passes
``device="cpu"``). Each slot

  receivers   grant their top-K SRPT messages (Homa) or an RTT window;
              the top-K is the hand-written ``srpt_topk`` CUDA kernel on
              ``backend="cuda"``
  senders     pick one chunk each by the sender policy's order
  network     single switch, or a two-tier leaf-spine fabric whose TOR
              uplink rings drain through the ``priority_arbiter`` kernel
  downlinks   drain one chunk per receiver, strict priority first and
              FIFO within a level (``priority_arbiter`` again)

``backend="fused"`` solves all three arbitration stages in one launch of
the ``fused_slot`` kernel at slot start (``_fused_precompute``).

A fabric with a fault layer (``FabricConfig.faults``, DESIGN.md §7) drops
chunks at its loss points, gates failed uplinks and TORs out of the
drains, and ends each slot with loss recovery
(``faults.apply_recovery``); the slot's draws and masks come from a plan
computed per block of slots (``faults.slot_plan``).

A host/NIC stage (``SimConfig.host``, :mod:`repro_torch.core.hostmodel`,
DESIGN.md §10) gates each sender on its TX CPU budget and passes drained
chunks through a bounded per-host RX service ring before they reach
``recv``; a full ring backpressures the downlink. In-loop telemetry
(``SimConfig.trace``, :mod:`repro_torch.core.telemetry`, DESIGN.md §8)
writes strided time series and an event ledger at the end of each slot.

The step carries a leading run axis B on every state tensor: a sweep
steps B independent runs at once (``run_sweep``), and ``simulate`` is
the case B = 1 — there is one step function. Integer outputs of every
run are bit-identical to the JAX package's ``simulate``. The loop never
reads a value back to the host: the slot counter is a device tensor, so
a later change can capture slots as a CUDA graph.

Entry points: ``simulate(cfg, table)`` -> :class:`SimResult`;
``run_sweep(cfg, spec)`` -> one result per run of a
:class:`repro_torch.core.sweep.SweepSpec`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults, spans, telemetry
from repro_torch.core.fabric import (FabricConfig, drain_select,
                                     init_fabric_state, ring_insert,
                                     route_chunks, spine_hash, take_slot,
                                     clear_slot, uplink_drain)
from repro_torch.core.hostmodel import (QSCALE, HostConfig, as_host_config,
                                        get_host_model)
from repro_torch.core.priorities import (PriorityAllocation,
                                         allocate_priorities,
                                         pias_thresholds)
from repro_torch.core.protocols import (BIG, I32, MSG_BITS, MSG_MOD,
                                        Protocol, get_protocol)
from repro_torch.core.results import SimResult, bucketed_percentiles
from repro_torch.core.telemetry import SimTrace, TraceConfig, \
    as_trace_config
from repro_torch.core.workloads import MessageTable
from repro_torch.kernels.arbiter import dispatch


def resolve_device(device) -> str:
    """``None`` -> ``"cuda"``. A CUDA device with no card raises: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         f"'cpu'")
    return str(dev)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_hosts: int = 16
    slot_bytes: int = 256
    n_prios: int = 8
    rtt_slots: int = 38                 # ~9.7 KB at 256 B slots
    net_delay_slots: int = 12           # sender NIC -> dst TOR eligibility
    grant_delay_slots: int = 19         # receiver decision -> sender visibility
    protocol: str = "homa"
    overcommit: int | None = None       # None: = n_sched (homa); basic: all
    ring_cap: int = 1024                # per-dst buffered chunks (TOR egress)
    phost_timeout_slots: int = 114      # ~3 RTT
    max_slots: int = 20_000
    fabric: FabricConfig | None = None  # None: single switch (DESIGN.md §5)
    # host/NIC software-overhead stage (repro_torch.core.hostmodel,
    # DESIGN.md §10): HostConfig | preset name ("ideal" | "kernel_stack"
    # | "kernel_bypass") | dict | None. None and zero-cost configs add
    # nothing to the loop, bit-identical to the host-free simulator.
    host: HostConfig | str | dict | None = None
    # in-loop telemetry (repro_torch.core.telemetry, DESIGN.md §8):
    # TraceConfig | dict | None; None and TraceConfig(enabled=False) add
    # nothing to the loop
    trace: TraceConfig | dict | None = None
    # "cuda" (the staged hand-written kernels) | "fused" (one fused kernel
    # launch per slot; the plain fused version on the CPU) | "reference"
    # (the plain versions); None: "cuda" on a CUDA device, "reference" on
    # the CPU
    backend: str | None = None
    # a knob of the JAX package's Pallas kernels; the port has none
    pallas_interpret: bool | None = None
    # "cuda" (default; raises without a card) or "cpu"
    device: str | None = None

    def __post_init__(self):
        get_protocol(self.protocol)     # ValueError on unknown protocol
        if self.pallas_interpret is not None:
            raise ValueError("SimConfig.pallas_interpret is a knob of the "
                             "JAX package's Pallas kernels; repro_torch has "
                             "none")
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "backend",
                           dispatch.resolve_backend(self.backend,
                                                    self.device))
        if self.fabric is not None:
            self.fabric.validate(self.n_hosts)
        object.__setattr__(self, "host", as_host_config(self.host))
        if self.host is not None:
            self.host.validate()
        object.__setattr__(self, "trace", as_trace_config(self.trace))
        if self.trace is not None:
            self.trace.validate()

    @property
    def rtt_bytes(self) -> int:
        return self.rtt_slots * self.slot_bytes

    @property
    def fabric_on(self) -> bool:
        """True iff the leaf-spine tier is modeled (``FabricConfig(None)``
        and ``fabric=None`` both mean the single-switch path)."""
        return self.fabric is not None and self.fabric.enabled

    @property
    def faults_on(self) -> bool:
        """True iff the fault/recovery layer is active (DESIGN.md §7).
        Faults hang off the fabric tier; ``fabric.faults=None`` (the
        default) keeps the loop loss-free and bit-identical to the
        fault-free simulator."""
        return self.fabric_on and self.fabric.faults is not None

    @property
    def trace_on(self) -> bool:
        """True iff in-loop telemetry is captured (DESIGN.md §8).
        ``trace=None`` and ``TraceConfig(enabled=False)`` both keep the
        loop identical to the untraced simulator."""
        return self.trace is not None and self.trace.enabled

    @property
    def ledger_on(self) -> bool:
        """True iff the protocol event ledger is captured (``trace_on``
        with a nonzero ``ledger_cap``)."""
        return self.trace_on and self.trace.ledger_cap > 0

    @property
    def host_on(self) -> bool:
        """True iff an active host/NIC stage is modeled (DESIGN.md §10).
        ``host=None`` and zero-overhead configs (the ``ideal`` preset)
        add nothing to the loop."""
        return self.host is not None and not self.host.is_ideal

    @property
    def host_tx_on(self) -> bool:
        """Send-side host gate active (nonzero TX cost)."""
        return self.host_on and self.host.tx_on

    @property
    def host_rx_on(self) -> bool:
        """Receive-side host FIFO active (nonzero RX cost)."""
        return self.host_on and self.host.rx_on

    @property
    def host_model(self):
        """The registered :class:`repro_torch.core.hostmodel.HostModel`."""
        return get_host_model(self.host.model)


def _to_slots(nbytes: np.ndarray, slot_bytes: int) -> np.ndarray:
    return np.maximum((nbytes + slot_bytes - 1) // slot_bytes, 1).astype(np.int32)


def prepare(cfg: SimConfig, table: MessageTable,
            alloc: PriorityAllocation | None = None,
            unsched_limit_bytes: int | np.ndarray | None = None):
    """Static per-message tensors of one run, on ``cfg.device``, keyed and
    shaped as the JAX package's ``prepare``; :func:`stack_static` gives
    them the run axis the loop carries."""
    proto = get_protocol(cfg.protocol)
    M = len(table.size)
    if M > MSG_MOD:
        raise ValueError(
            f"table has {M} messages but the simulator's packed sort keys "
            f"hold at most {MSG_MOD} (MSG_BITS={MSG_BITS}); split the "
            f"table into shorter runs")
    if cfg.max_slots >= 2 ** 21:
        raise ValueError(
            f"max_slots={cfg.max_slots} overflows the int32 sort-key "
            f"encoding (limit 2**21-1 = {2 ** 21 - 1}); lower max_slots "
            f"or coarsen slot_bytes so the horizon fits")
    size_slots = _to_slots(table.size, cfg.slot_bytes)

    if alloc is None:
        alloc = allocate_priorities(table.size, unsched_limit=cfg.rtt_bytes,
                                    n_prios=cfg.n_prios)

    ul = proto.unsched_limit(cfg, M, unsched_limit_bytes)
    unsched_slots = np.minimum(_to_slots(ul, cfg.slot_bytes), size_slots)
    up = proto.unsched_prio(cfg, table.size, alloc)

    # PIAS: sender-side MLFQ demotion thresholds (slots of bytes sent)
    pias_cut = pias_thresholds(table.size, cfg.n_prios)
    pias_cut_slots = _to_slots(np.asarray(pias_cut + [1 << 40]),
                               cfg.slot_bytes) if pias_cut else \
        np.array([1 << 20], np.int32)

    # unloaded baseline (slots): cross-rack chunks traverse leaf + spine
    net_delay = np.full(M, cfg.net_delay_slots, np.int64)
    if cfg.fabric_on:
        rs = cfg.fabric.rack_size(cfg.n_hosts)
        cross = (table.src // rs) != (table.dst // rs)
        net_delay = np.where(cross, cfg.fabric.leaf_delay_slots
                             + cfg.fabric.spine_delay_slots, net_delay)

    static = {
        "src": np.asarray(table.src, np.int32),
        "dst": np.asarray(table.dst, np.int32),
        "size": size_slots,
        "arrival": np.asarray(table.arrival_slot, np.int32),
        "unsched": np.asarray(unsched_slots, np.int32),
        "uprio": np.asarray(up, np.int32),
        "pias_cuts": np.asarray(pias_cut_slots, np.int32),
        "dst_onehot": np.arange(cfg.n_hosts)[:, None] == table.dst[None, :],
        "msg_ids": np.arange(M, dtype=np.int32),
        "ideal": np.asarray(size_slots + net_delay, np.int32),
    }
    if cfg.fabric_on:
        # per-message ECMP spine choice (seeded, deterministic)
        static["spine"] = spine_hash(
            table.src, table.dst, np.arange(M), cfg.fabric.seed,
            cfg.fabric.n_uplinks(cfg.n_hosts))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(cfg.device)
            for k, v in static.items()}, alloc


def stack_static(statics: list[dict]) -> dict:
    """The :func:`prepare` statics of B runs of one shape, stacked on a
    leading run axis."""
    return {k: torch.stack([S[k] for S in statics]) for k in statics[0]}


def _init_state(cfg: SimConfig, proto: Protocol, M: int, B: int = 1):
    """Slot-0 state of B runs: every tensor has a leading run axis."""
    H, cap, Dg = cfg.n_hosts, cfg.ring_cap, cfg.grant_delay_slots
    dev = cfg.device

    def z(*shape):
        return torch.zeros((B, *shape), dtype=I32, device=dev)

    def full(v, *shape):
        return torch.full((B, *shape), v, dtype=I32, device=dev)

    return {
        **proto.extra_state(cfg, M, B),       # protocol-private carry
        **(init_fabric_state(cfg, B) if cfg.fabric_on else {}),
        **(faults.init_fault_state(cfg, M, B) if cfg.faults_on else {}),
        **(cfg.host_model.init_state(cfg, M, B) if cfg.host_on else {}),
        **(telemetry.init_trace_state(cfg, M, B) if cfg.trace_on else {}),
        "sent": z(M),
        "granted_s": z(M),                    # sender-visible grant (slots)
        "grant_r": z(M),                      # receiver-issued grant (slots)
        "recv": z(M),
        "sched_prio": z(M),
        "completion": full(-1, M),
        # downlink rings; a chunk's network-arrival time is r_seq +
        # net_delay_slots
        "r_msg": full(-1, H, cap),
        "r_prio": full(BIG, H, cap),          # smaller = served first
        "r_seq": full(BIG, H, cap),
        "r_valid": torch.zeros((B, H, cap), dtype=torch.bool, device=dev),
        # delayed receiver state (grant/prio propagation)
        "hist_grant": z(Dg, M),
        "hist_prio": z(Dg, M),
        # stats
        "busy": z(H), "wasted": z(H), "lost": z(),
        "q_sum": torch.zeros((B, H), dtype=torch.float32, device=dev),
        "q_max": z(H),
        "prio_drained": z(cfg.n_prios),
        "uplink_busy": z(H),
    }


def _sender_select(cfg: SimConfig, proto: Protocol, st, S, now):
    """Pick one message per host by the sender policy's order key."""
    size, src = S["size"], S["src"]
    arrived = S["arrival"] <= now
    sendable = arrived & (st["sent"] < st["granted_s"]) & (st["sent"] < size)
    remaining = (size - st["sent"]).clamp_min(0)
    order = proto.sender.order(cfg, st, S, now, remaining)
    key = torch.where(sendable, (order << MSG_BITS) | S["msg_ids"], BIG)
    # segment_min over the sending host of each run (segment b * H + src,
    # as a scatter along the message axis of a (B, H) target); an empty
    # host keeps BIG
    host_min = torch.full((key.shape[0], cfg.n_hosts), BIG, dtype=I32,
                          device=key.device).scatter_reduce_(
        1, src.long(), key, "amin", include_self=True)
    has = host_min < BIG
    chosen = torch.where(has, host_min & (MSG_MOD - 1), MSG_MOD)  # (B, H)
    return chosen, has


def _fused_precompute(cfg: SimConfig, proto: Protocol, S, n_sched: int,
                      st, now, fx=None):
    """``fused`` backend (DESIGN.md §11): solve ALL of this slot's
    arbitration — downlink drain, TOR uplink drain, SRPT grant top-K — in
    one kernel launch at slot start, before the stages that normally
    interleave with them. Returns ``(st, grant_st, fused)``:

      st        slot state, with the host RX delivery already applied
                when the downlink stage is fused (its room gate is a
                kernel input; ``rx_deliver`` touches only RX-ring state
                and ``recv``, which stages 1–3 read only in the grants)
      grant_st  the state the receiver policy must see: slot-start
                ``recv`` (grants run before RX delivery in the staged
                order), everything else current
      fused     per-stage answers: ``"down"``/``"up"`` -> the
                ``drain_select`` triple, ``"topk"`` -> ``(vals, idx)``
                for ``ReceiverPolicy.grants``; ``{}`` when nothing is
                fusable

    Hoisting the drains is bit-exact because every chunk inserted later
    in the slot is ineligible until the next slot (``net_delay_slots >=
    1`` / ``leaf_delay_slots >= 1`` / validated ``spine_delay_slots >=
    1``) and ``ring_insert`` only ever writes invalid slots, so the
    winners and their payloads are unchanged. A stage whose delay
    precondition fails is simply not fused — the staged kernel runs at
    its usual point instead. The fault masks (``fx``, the slot's plan
    row) enter at the points the staged order applies them: the TOR
    gate on the downlink eligibility, the link gate on the uplink's; the
    RX-ring room gate (and its stall count) comes after the TOR gate."""
    fuse_down = cfg.net_delay_slots >= 1
    fuse_up = cfg.fabric_on and cfg.fabric.leaf_delay_slots >= 1
    fl = cfg.fabric.faults if cfg.faults_on else None
    prob = proto.receiver.grant_problem(cfg, st, S, now, n_sched)
    grant_st = st
    down = up = None
    if fuse_down:
        if cfg.host_rx_on:
            recv_pre = st["recv"]
            st = cfg.host_model.rx_deliver(cfg, st, S, now)
            room = cfg.host_model.rx_room(cfg, st)
            grant_st = {**st, "recv": recv_pre}
        eligible = st["r_valid"] & (st["r_seq"] + cfg.net_delay_slots
                                    <= now)
        if fl is not None and fl.tor_fail:
            eligible = eligible & ~fx["host_down"][:, None]
        if cfg.host_rx_on:
            st = {**st, "h_rx_stall": st["h_rx_stall"]
                  + (eligible.any(dim=2) & ~room).to(I32)}
            eligible = eligible & room[:, :, None]
        down = (st["r_prio"], st["r_seq"], eligible)
    if fuse_up:
        u_elig = st["u_valid"] & (st["u_seq"] + cfg.fabric.leaf_delay_slots
                                  <= now)
        if fl is not None and (fl.link_fail or fl.tor_fail):
            u_elig = u_elig & ~fx["link_down"][:, None]
        up = (st["u_prio"], st["u_seq"], u_elig)
    if down is None and up is None and prob is None:
        return st, grant_st, {}
    out = dispatch.fused_slot(down=down, up=up, topk=prob, backend="fused")
    fused = {}
    for name in ("down", "up"):
        if name in out:
            bp, bi = out[name]
            fused[name] = (bi, bp < BIG, bp)
    if "topk" in out:
        fused["topk"] = out["topk"]
    return st, grant_st, fused


def step_fn(cfg: SimConfig, proto: Protocol, S, n_sched: int, st, now,
            fx=None):
    """One link-time slot of B runs: policy-agnostic orchestration of
    receivers, uplinks, the network, and the priority-queue downlinks.
    ``S`` and ``st`` carry a leading run axis; ``now`` is a 0-d int32
    tensor on the state's device, shared by all runs. ``fx`` is the
    slot's fault plan row (``faults.plan_row``, as :func:`run_slots`
    passes it), needed where ``faults.plan_needed(cfg)``."""
    H, Dg = cfg.n_hosts, cfg.grant_delay_slots
    B, M = S["size"].shape

    # slot-start references for the telemetry event deltas (DESIGN.md §8)
    tr_prev = telemetry.snapshot(cfg, st) if cfg.trace_on else None

    # ---- 0. fused backend: one kernel for ALL of this slot's
    # arbitration (DESIGN.md §11); {} when nothing is fusable
    grant_st, fused = st, {}
    if cfg.backend == "fused":
        st, grant_st, fused = _fused_precompute(cfg, proto, S, n_sched, st,
                                                now, fx)

    # ---- 1. receiver policy (current state), store into delay history
    with spans.slot("slot.grants"):
        grant_r, sched_prio, active, withheld = proto.receiver.grants(
            cfg, grant_st, S, now, n_sched, topk=fused.get("topk"))
        st = {**st, "grant_r": grant_r, "sched_prio": sched_prio}
        row = (now % Dg).long().view(1)
        hist_grant = st["hist_grant"].index_copy(1, row, grant_r[:, None])
        hist_prio = st["hist_prio"].index_copy(1, row, sched_prio[:, None])
        # sender sees the entry written Dg-1 slots ago
        vis = ((now + 1) % Dg).long().view(1)
        grant_vis = hist_grant.index_select(1, vis)[:, 0]
        prio_vis = hist_prio.index_select(1, vis)[:, 0]

        arrived = S["arrival"] <= now
        blind = torch.where(arrived, S["unsched"], 0)
        granted_s = torch.maximum(torch.maximum(st["granted_s"], blind),
                                  grant_vis)
        st = {**st, "granted_s": granted_s, "hist_grant": hist_grant,
              "hist_prio": hist_prio,
              "sched_prio": torch.where(arrived, prio_vis,
                                        st["sched_prio"])}
        # NOTE: sender uses delayed sched_prio (the grant packet's priority)

    # ---- 2. senders pick + transmit one chunk (sender policy)
    chosen, has = _sender_select(cfg, proto, st, S, now)
    if cfg.host_tx_on:
        # host/NIC stage (DESIGN.md §10): the selected chunk only makes
        # the wire if the host's TX CPU budget covers it this slot
        has, st = cfg.host_model.host_tx(cfg, st, has, now)
    cm = chosen.clamp_max(M - 1)                        # (B, H) int32
    cml = cm.long()                                     # gather index
    unsched_chunk = st["sent"].gather(1, cml) < S["unsched"].gather(1, cml)
    prio_chunk = proto.sender.chunk_prio(cfg, st, S, cml, unsched_chunk,
                                         n_sched)
    has_i = has.to(I32)
    st = {**st, "sent": st["sent"].scatter_add(1, cml, has_i),
          "uplink_busy": st["uplink_busy"] + has_i}
    st = proto.sender.on_send(cfg, st, S, cml, has, now)

    # ---- 3. route chunks into the first queueing tier: the destination
    # downlink ring (single switch), or the leaf / TOR uplink rings
    dsts = torch.where(has, S["dst"].gather(1, cml), H)       # sentinel H
    if not cfg.fabric_on:
        r_msg, r_prio, r_seq, r_valid, n_drop = ring_insert(
            st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
            dsts, has, cm, prio_chunk, now.expand(B, H))
        st = {**st, "r_msg": r_msg, "r_prio": r_prio, "r_seq": r_seq,
              "r_valid": r_valid, "lost": st["lost"] + n_drop}
    else:
        st = route_chunks(cfg, st, S, cm, has, dsts, prio_chunk, now, fx)
        with spans.slot("slot.uplink"):
            st = uplink_drain(cfg, st, S, now, pre=fused.get("up"), fx=fx)

    # ---- 4. downlink drain: strict priority, FIFO within level
    # (the priority_arbiter kernel on backend="cuda"; pre-solved at slot
    # start on backend="fused" — this slot's insertions carry seq == now
    # and cannot be eligible yet, so the hoisted winner is the same)
    with spans.slot("slot.drain"):
        eligible = st["r_valid"] & (st["r_seq"] + cfg.net_delay_slots
                                    <= now)
        if cfg.faults_on and cfg.fabric.faults.tor_fail:
            # hosts behind a failed TOR drain nothing for the window;
            # their buffered chunks survive and resume draining when it
            # lifts
            eligible = eligible & ~fx["host_down"][:, None]
        q_eligible = eligible                   # backlog incl. stalled rows
        if "down" in fused:
            # pre-solved at slot start with the RX delivery and room gate
            # (_fused_precompute); q_eligible is the kernel's eligibility
            # before the room gate
            slot_idx, any_elig, pmin = fused["down"]
        else:
            if cfg.host_rx_on:
                # host/NIC RX stage (DESIGN.md §10): finish service on
                # ring entries whose CPU time elapsed (feeds recv ->
                # grants AND completions), then gate the downlink on
                # RX-ring room — a full ring backpressures the network
                # (chunks stay queued)
                hm = cfg.host_model
                st = hm.rx_deliver(cfg, st, S, now)
                room = hm.rx_room(cfg, st)
                st = {**st, "h_rx_stall": st["h_rx_stall"]
                      + (eligible.any(dim=2) & ~room).to(I32)}
                eligible = eligible & room[:, :, None]
            slot_idx, any_elig, pmin = drain_select(
                st["r_prio"], st["r_seq"], eligible, backend=cfg.backend)
        drained_msg = torch.where(any_elig, take_slot(st["r_msg"], slot_idx),
                                  M)
        any_i = any_elig.to(I32)
        if cfg.host_rx_on:
            # drained chunks enter the RX ring; recv advances in rx_deliver
            st = cfg.host_model.rx_accept(cfg, st, S, drained_msg, any_elig,
                                          now)
            recv = st["recv"]
        else:
            recv = st["recv"].scatter_add(
                1, drained_msg.clamp_max(M - 1).long(), any_i)
        r_valid = clear_slot(st["r_valid"], slot_idx, any_elig)
        st = proto.on_drain(cfg, st, S, drained_msg, any_elig, now)

        completion = torch.where((recv >= S["size"])
                                 & (st["completion"] < 0),
                                 now, st["completion"])

    # ---- 5. stats
    with spans.slot("slot.stats"):
        qlen = q_eligible.sum(dim=2, dtype=I32) - any_i
        drained_prio = torch.where(any_elig,
                                   pmin.clamp_max(cfg.n_prios - 1), 0)
        prio_drained = st["prio_drained"].scatter_add(
            1, drained_prio.long(), any_i)
        known_inc = (recv > 0) & (completion < 0)
        has_known = (S["dst_onehot"] & known_inc[:, None, :]).any(dim=2)
        wasted = st["wasted"] + (~any_elig & withheld & has_known).to(I32)

        st = {**st, "recv": recv, "r_valid": r_valid,
              "completion": completion, "busy": st["busy"] + any_i,
              "q_sum": st["q_sum"] + qlen.to(torch.float32),
              "q_max": torch.maximum(st["q_max"], qlen),
              "wasted": wasted, "prio_drained": prio_drained}

    # ---- 5b. loss recovery (fault-enabled fabrics only, DESIGN.md §7):
    # receiver RESENDs + sender fallback timeouts rewind quiet messages'
    # send offsets so fault-dropped chunks get retransmitted
    if cfg.faults_on:
        st = faults.apply_recovery(cfg, proto, st, S, now, drained_msg,
                                   any_elig)

    # ---- 6. protocol end-of-slot hook (e.g. pHost sender timeouts)
    st = proto.post_step(cfg, st, S, now, active, drained_msg, any_elig)

    # ---- 7. telemetry capture (ledger append + strided series rows)
    if cfg.trace_on:
        st = telemetry.capture_slot(cfg, st, S, now, tr_prev, active, qlen)
    return st


def run_slots(cfg: SimConfig, proto: Protocol, S, st, n_sched: int,
              start: int, stop: int):
    """Step the (stacked) state through slots ``start .. stop-1``.
    Nothing is read back to the host, so the loop only enqueues work on a
    card. A fault layer or flowlet routing reads its draws and masks from
    a plan computed once per block of slots (``faults.slot_plan``). While
    ``torch.profiler`` records, each slot and its stages are slot spans
    (:mod:`repro_torch.core.spans`)."""
    now = torch.full((), start, dtype=I32, device=cfg.device)
    M = S["size"].shape[1]
    planned = faults.plan_needed(cfg)
    block = faults.plan_block(cfg, M) if planned else max(stop - start, 1)
    with torch.inference_mode(), spans.RECORDER.slot_tier():
        for lo in range(start, stop, block):
            hi = min(lo + block, stop)
            plan = faults.slot_plan(cfg, M, lo, hi) if planned else None
            for t in range(lo, hi):
                with spans.slot("slot"):
                    fx = faults.plan_row(cfg, plan, lo, t) if planned \
                        else None
                    st = step_fn(cfg, proto, S, n_sched, st, now, fx)
                    now = now + 1
    return st


def host_state(st: dict) -> dict:
    """Numpy copies of a (stacked) state, for :func:`_finalize`."""
    return {k: v.cpu().numpy() for k, v in st.items()}


def _finalize(cfg: SimConfig, table: MessageTable, S, alloc, st, b: int,
              return_state: bool, reduce_trace: bool = False,
              timings: dict | None = None) -> SimResult:
    """Numpy post-processing of run ``b``: ``S`` is its :func:`prepare`
    statics, ``st`` the stacked final state of its batch
    (:func:`host_state`). ``reduce_trace=True`` (the ``run_sweep`` path)
    keeps only the scalars of a captured trace (``trace_summary``);
    ``timings`` is :func:`telemetry.timings`'s split."""
    S = {k: v.cpu().numpy() for k, v in S.items()}
    st = {k: v[b] for k, v in st.items()}
    size_slots = S["size"]
    arrival = S["arrival"]
    done = st["completion"] >= 0
    elapsed = np.where(done, st["completion"] - arrival + 1, -1)
    ideal = S["ideal"].astype(np.int64)
    slowdown = np.where(done, elapsed / ideal, np.nan)

    fabric = None
    tor_kw = {}
    if cfg.fabric_on:
        fab = cfg.fabric
        fabric = {"racks": fab.racks,
                  "rack_size": fab.rack_size(cfg.n_hosts),
                  "n_uplinks": fab.n_uplinks(cfg.n_hosts),
                  "oversub": fab.oversub, "seed": fab.seed,
                  "routing": fab.routing}
        tor_kw = dict(
            tor_up_busy_frac=st["u_busy"] / cfg.max_slots,
            tor_up_q_mean_bytes=st["u_q_sum"] / cfg.max_slots
            * cfg.slot_bytes,
            tor_up_q_max_bytes=st["u_q_max"] * cfg.slot_bytes,
            tor_up_lost_chunks=int(st["u_lost"]))
    if cfg.faults_on:
        first_loss = st["first_loss"]
        affected = first_loss < 2 ** 30
        # recovery time: first fault-drop on the message -> completion;
        # -1 for messages never hit (or never finished)
        tor_kw.update(
            faults=dataclasses.asdict(cfg.fabric.faults),
            retx_chunks=st["retx"],
            msg_lost_chunks=st["msg_lost"],
            recovery_slots=np.where(done & affected,
                                    st["completion"] - first_loss, -1),
            fault_lost_chunks=int(st["f_lost"]))
    if cfg.host_on:
        tor_kw["host"] = dataclasses.asdict(cfg.host)
        if cfg.host_tx_on:
            tor_kw.update(
                host_tx_busy_frac=st["h_tx_work_q"]
                / (cfg.max_slots * QSCALE),
                host_tx_defer_frac=st["h_tx_defer"] / cfg.max_slots)
        if cfg.host_rx_on:
            tor_kw.update(
                host_rx_stall_frac=st["h_rx_stall"] / cfg.max_slots,
                host_rx_q_mean_chunks=st["h_rx_q_sum"] / cfg.max_slots,
                host_rx_q_max_chunks=st["h_rx_q_max"])

    trace = trace_summary = None
    if cfg.trace_on:
        tr = telemetry.finalize_trace(cfg, st, timings)
        trace_summary = tr.reduce()
        if not reduce_trace:
            trace = tr
    elif timings is not None:
        # wallclock-only run (capture disabled): keep the split
        trace_summary = {"timings": timings}

    return SimResult(
        protocol=cfg.protocol, alloc=alloc,
        completion=st["completion"], elapsed=elapsed, ideal=ideal,
        slowdown=slowdown, done=done,
        size_slots=size_slots, size_bytes=np.asarray(table.size),
        busy_frac=st["busy"] / cfg.max_slots,
        wasted_frac=st["wasted"] / cfg.max_slots,
        uplink_busy_frac=st["uplink_busy"] / cfg.max_slots,
        q_mean_bytes=st["q_sum"] / cfg.max_slots * cfg.slot_bytes,
        q_max_bytes=st["q_max"] * cfg.slot_bytes,
        prio_drained_bytes=st["prio_drained"] * cfg.slot_bytes,
        lost_chunks=int(st["lost"]) + int(st.get("u_lost", 0)),
        n_complete=int(done.sum()), n_messages=len(size_slots),
        fabric=fabric, **tor_kw,
        trace=trace, trace_summary=trace_summary,
        state=st if return_state else None,
        static=S if return_state else None,
    )


def simulate(cfg: SimConfig, table: MessageTable,
             alloc: PriorityAllocation | None = None,
             unsched_limit_bytes=None,
             return_state: bool = False) -> SimResult:
    """Run one simulation of ``cfg.max_slots`` slots on ``cfg.device``;
    returns a structured :class:`SimResult` (numpy arrays).

    The run's stages are call spans (:mod:`repro_torch.core.spans`):
    ``simulate.prepare`` (``prepare`` and the slot-0 state),
    ``simulate.load`` (loading the kernel library the backend launches)
    and ``simulate.run`` (the slot loop). With ``cfg.trace =
    TraceConfig(wallclock=True)`` the loop runs
    ``wallclock_repeats`` times from the same state, each between two
    synchronizations, and the spans' split lands in
    ``result.trace.timings`` (``result.trace_summary["timings"]`` when
    capture is disabled; :func:`repro_torch.core.telemetry.timings`)."""
    proto = get_protocol(cfg.protocol)
    M = len(table.size)
    wall = cfg.trace is not None and cfg.trace.wallclock
    sync = torch.cuda.synchronize \
        if wall and torch.device(cfg.device).type == "cuda" \
        else (lambda: None)
    with spans.span("simulate.prepare") as prep:
        S, alloc = prepare(cfg, table, alloc, unsched_limit_bytes)
        st0 = _init_state(cfg, proto, M)
    with spans.span("simulate.load") as load:
        dispatch.load_kernels(cfg.backend, cfg.device)
    runs = []
    for _ in range(cfg.trace.wallclock_repeats if wall else 1):
        sync()
        with spans.span("simulate.run") as run:
            st = run_slots(cfg, proto, stack_static([S]), st0,
                           proto.n_sched(cfg, alloc), 0, cfg.max_slots)
            sync()
        runs.append(run)
    timings = telemetry.timings(prep, load, runs) if wall else None
    return _finalize(cfg, table, S, alloc, host_state(st), 0, return_state,
                     timings=timings)


def run_sweep(cfg: SimConfig, spec) -> list:
    """Run the independent simulations a
    :class:`repro_torch.core.sweep.SweepSpec` describes, each static-shape
    group of them as one batch on the step's run axis::

        run_sweep(cfg, SweepSpec(seeds=(0, 1, 2, 3), workload="W1",
                                 load=0.8, shared_alloc=True,
                                 chunk_slots=512, streaming=True))

    Returns one result per run, in input order: :class:`SimResult` for
    exact sweeps, :class:`repro_torch.core.sweep.SweepStats` when
    ``spec.streaming`` is set. Results are bit-identical to sequential
    :func:`simulate` calls (see ``repro_torch.core.sweep``)."""
    from repro_torch.core import sweep
    if not isinstance(spec, sweep.SweepSpec):
        raise TypeError(f"run_sweep(cfg, spec) takes a SweepSpec, got "
                        f"{type(spec).__name__}")
    return sweep.run_spec(cfg, spec)


def slowdown_percentiles(stats: dict | SimResult, pct: float = 99.0,
                         n_buckets: int = 10) -> dict:
    """Percentile slowdown bucketed by message size (paper Figs. 8/12).
    Accepts a :class:`SimResult` or the legacy stats dict."""
    if isinstance(stats, SimResult):
        return stats.percentiles_by_size(pct, n_buckets)
    return bucketed_percentiles(stats["size_bytes"], stats["slowdown"],
                                stats["done"], pct, n_buckets)


__all__ = ["SimConfig", "FabricConfig", "TraceConfig", "SimTrace",
           "HostConfig", "simulate", "run_sweep", "prepare",
           "stack_static", "step_fn", "run_slots", "SimResult",
           "resolve_device", "slowdown_percentiles"]
