"""Two-tier leaf-spine fabric model (paper §5.2 topology; DESIGN.md §5),
in PyTorch — the port of ``repro.core.fabric``.

  host NIC ──> TOR ──(same rack: leaf switching)──> dst downlink queue
                └──(cross rack: UPLINK PRIORITY QUEUE ──> spine)──┘

Each TOR has ``n_uplinks = max(1, round(rack_size / oversub))`` uplinks,
one per spine, each draining one chunk per slot with the same
strict-priority-then-FIFO arbitration as the receiver downlinks. A
chunk's uplink is a seeded hash of ``(src, dst, msg_id, seed)`` computed
once per message at prepare time (ECMP at message granularity).
Cross-rack chunks wait ``leaf_delay_slots`` before uplink service, then
``spine_delay_slots`` more before downlink service.

``routing="flowlet"`` / ``"adaptive"`` and a fault layer (``faults=``, a
:class:`~repro_torch.core.faults.FaultConfig`) come from
:mod:`repro_torch.core.faults` (DESIGN.md §7); ``faults=None`` keeps the
loop loss-free and bit-identical to the fault-free simulator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.faults import (FaultConfig, fault_span,
                                     forward_losses, inject_losses,
                                     select_uplink)
from repro_torch.core.protocols import BIG, I32
from repro_torch.kernels.arbiter import dispatch
from repro_torch.kernels.arbiter.ref import priority_arbiter_ref

ROUTING_POLICIES = ("ecmp", "flowlet", "adaptive")


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Leaf-spine topology parameters (the JAX package's fields).

    ``FabricConfig(None)`` is the disabled sentinel — single-switch
    behavior, bit-identical to ``SimConfig.fabric=None``.
    """
    racks: int | None = None        # None disables the fabric tier
    oversub: float = 2.0            # rack offered bw : uplink bw ratio
    leaf_delay_slots: int = 6       # host NIC -> TOR uplink service
    spine_delay_slots: int = 6      # uplink service -> dst downlink service
    up_cap: int = 512               # per-uplink buffered chunks
    seed: int = 0                   # spine-hash seed (ECMP placement)
    # spine selection policy (DESIGN.md §7): "ecmp" is the static
    # per-message hash; "flowlet" re-hashes every flowlet_slots;
    # "adaptive" picks the least-loaded live uplink
    routing: str = "ecmp"
    flowlet_slots: int = 64         # flowlet epoch length (~1.7 RTT)
    # fault injection + loss recovery (repro_torch.core.faults); None
    # keeps the loop loss-free
    faults: FaultConfig | None = None

    def __post_init__(self):
        # JSON round-trip convenience: accept a plain dict for faults
        if isinstance(self.faults, dict):
            object.__setattr__(self, "faults", FaultConfig(**self.faults))
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {self.routing!r}; available: "
                f"{list(ROUTING_POLICIES)}")

    @property
    def enabled(self) -> bool:
        return self.racks is not None

    def validate(self, n_hosts: int) -> None:
        if not self.enabled:
            return
        if self.racks < 1:
            raise ValueError(f"FabricConfig.racks must be >= 1, got "
                             f"{self.racks}")
        if n_hosts % self.racks:
            raise ValueError(
                f"n_hosts={n_hosts} is not divisible by racks={self.racks}; "
                f"the leaf-spine model needs equal-size racks")
        if self.oversub <= 0:
            raise ValueError(f"FabricConfig.oversub must be > 0, got "
                             f"{self.oversub}")
        if self.leaf_delay_slots < 0:
            raise ValueError("FabricConfig.leaf_delay_slots must be >= 0")
        if self.spine_delay_slots < 1:
            raise ValueError(
                "FabricConfig.spine_delay_slots must be >= 1 (a chunk "
                "cannot traverse uplink and downlink in the same slot)")
        if self.up_cap < 1:
            raise ValueError("FabricConfig.up_cap must be >= 1")
        if self.flowlet_slots < 1:
            raise ValueError("FabricConfig.flowlet_slots must be >= 1")
        if self.faults is not None:
            self.faults.validate(self, n_hosts)

    # ---- derived topology (python ints: shape parameters for the loop)

    def rack_size(self, n_hosts: int) -> int:
        return n_hosts // self.racks

    def n_uplinks(self, n_hosts: int) -> int:
        """Uplinks per TOR (= number of spines each TOR reaches)."""
        return max(1, int(round(self.rack_size(n_hosts) / self.oversub)))

    def n_uplinks_total(self, n_hosts: int) -> int:
        return self.racks * self.n_uplinks(n_hosts)

    # ---- failure-scenario constructors (DESIGN.md §7). Each returns a
    # new frozen config with the fault layered onto any existing
    # FaultConfig; scenarios.lossy_fabric / uplink_failure / tor_failure
    # wrap them.

    def with_faults(self, **fault_kw) -> "FabricConfig":
        """New config with ``fault_kw`` merged into the fault layer."""
        if not self.enabled:
            raise ValueError("failure scenarios need an enabled fabric "
                             "(FabricConfig with racks set): faults model "
                             "loss on leaf-spine links")
        base = dataclasses.asdict(self.faults) \
            if self.faults is not None else {}
        return dataclasses.replace(
            self, faults=FaultConfig(**{**base, **fault_kw}))

    def with_lossy(self, *, up_loss: float = 0.0, down_loss: float = 0.0,
                   ge_p_gb: float = 0.0, ge_p_bg: float = 0.05,
                   ge_loss: float = 0.5, seed: int = 0) -> "FabricConfig":
        """Steady-state lossy links: Bernoulli uplink/downlink chunk
        loss, optionally with a Gilbert-Elliott burst component."""
        return self.with_faults(up_loss=up_loss, down_loss=down_loss,
                                ge_p_gb=ge_p_gb, ge_p_bg=ge_p_bg,
                                ge_loss=ge_loss, seed=seed)

    def with_uplink_failure(self, *, uplink: int, start: int,
                            end: int) -> "FabricConfig":
        """One TOR uplink black-holes all traffic for ``[start, end)``
        slots: static ECMP keeps hashing flows into the dead spine until
        the window lifts."""
        prior = self.faults.link_fail if self.faults is not None else ()
        return self.with_faults(link_fail=prior + ((uplink, start, end),))

    def with_tor_failure(self, *, rack: int, start: int,
                         end: int) -> "FabricConfig":
        """A whole TOR fails for ``[start, end)`` slots: the rack's
        uplinks and host downlinks all go dark; recovery timeouts must
        carry every in-flight message across the window."""
        prior = self.faults.tor_fail if self.faults is not None else ()
        return self.with_faults(tor_fail=prior + ((rack, start, end),))


def spine_hash(src: np.ndarray, dst: np.ndarray, msg_id: np.ndarray,
               seed: int, n_uplinks: int) -> np.ndarray:
    """Deterministic per-message spine choice in ``[0, n_uplinks)``: an
    xorshift-multiply mix of (src, dst, msg_id, seed), in numpy uint32 at
    prepare time exactly as the JAX package computes it."""
    seed_mix = np.uint32((seed * 0x27D4EB2F) & 0xFFFFFFFF)
    h = (np.asarray(src, np.uint32) * np.uint32(0x9E3779B1)
         ^ np.asarray(dst, np.uint32) * np.uint32(0x85EBCA77)
         ^ np.asarray(msg_id, np.uint32) * np.uint32(0xC2B2AE3D)
         ^ seed_mix)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return (h % np.uint32(n_uplinks)).astype(np.int32)


# ------------------------------------------------------- ring primitives ---
# Shared by downlink and uplink tiers: a (B, R, cap) pool of ring buffers
# (B runs of R rings each) with occupancy-based insertion and
# strict-priority / FIFO drain.

def ring_insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq, *,
                backend: str = "reference"):
    """Insert up to ``n`` chunks per run into per-row rings.

    Rings are ``(B, R, cap)``; ``row``/``ok``/``msg``/``prio``/``seq`` are
    ``(B, n)``. Item i of run b goes into ring ``row[b, i]`` of that run
    iff ``ok[b, i]``; several items may target one row in a slot (they
    take consecutive free slots in input order). A chunk is dropped only
    when its ring is actually full. Returns the four updated ring arrays
    plus the dropped count per run, ``(B,)`` int32.

    On the kernel backends (``"cuda"``, ``"fused"``) with the rings on the
    card, ``ring_insert_kernel`` updates the four ring tensors in place
    and returns the same tensors: the call consumes them, and a caller
    may not keep a reference to them to read the rings as they were
    before the call (take a ``clone()`` first). The ``reference`` backend
    and CPU tensors run the plain version
    (``kernels/arbiter/ref.py`` ``ring_insert_ref``), which returns new
    tensors and leaves its arguments as they were."""
    with spans.slot("ring.insert"):
        return dispatch.insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg,
                               prio, seq, backend=backend)


def ring_drain_select(prio_a, seq_a, eligible):
    """Pick one chunk per row: strict priority, FIFO (seq) within level.
    Returns ``(slot_idx, any_elig, pmin)``. The math is the plain version
    of the ``priority_arbiter`` kernel."""
    pmin, slot_idx = priority_arbiter_ref(prio_a, seq_a, eligible)
    return slot_idx, pmin < BIG, pmin


def drain_select(prio_a, seq_a, eligible, *, backend: str = "reference"):
    """Backend-dispatched :func:`ring_drain_select` on rings with any
    leading axes: the kernel backends run the hand-written
    ``priority_arbiter`` kernel on all rows of all runs in one launch,
    bit-identical to the plain version."""
    lead, cap = prio_a.shape[:-1], prio_a.shape[-1]
    bp, bi = dispatch.arbitrate(prio_a.reshape(-1, cap),
                                seq_a.reshape(-1, cap),
                                eligible.reshape(-1, cap), backend=backend)
    bp, bi = bp.view(lead), bi.view(lead)
    return bi, bp < BIG, bp


def take_slot(a, slot_idx):
    """``a[..., r, slot_idx[..., r]]`` for every row r."""
    return a.gather(-1, slot_idx.long()[..., None])[..., 0]


def clear_slot(valid_a, slot_idx, drained):
    """``valid_a[..., r, slot_idx[..., r]] = False`` on the rows that
    drained."""
    si = slot_idx.long()[..., None]
    return valid_a.scatter(-1, si, valid_a.gather(-1, si)
                           & ~drained[..., None])


# ------------------------------------------------------- fabric stages -----

def init_fabric_state(cfg, B: int) -> dict:
    """Uplink-tier loop state of B runs; only fabric-enabled configs carry
    it."""
    fab = cfg.fabric
    U, ucap = fab.n_uplinks_total(cfg.n_hosts), fab.up_cap
    dev = cfg.device
    return {
        "u_msg": torch.full((B, U, ucap), -1, dtype=I32, device=dev),
        "u_prio": torch.full((B, U, ucap), BIG, dtype=I32, device=dev),
        "u_seq": torch.full((B, U, ucap), BIG, dtype=I32, device=dev),
        "u_valid": torch.zeros((B, U, ucap), dtype=torch.bool, device=dev),
        "u_busy": torch.zeros((B, U), dtype=I32, device=dev),
        "u_q_sum": torch.zeros((B, U), dtype=torch.float32, device=dev),
        "u_q_max": torch.zeros((B, U), dtype=I32, device=dev),
        "u_lost": torch.zeros((B,), dtype=I32, device=dev),
    }


def route_chunks(cfg, st, S, cm, has, dsts, prio_chunk, now, fx=None):
    """Route this slot's transmitted chunks into the first queueing tier:
    same-rack chunks switch at the leaf straight into the destination
    downlink ring; cross-rack chunks enter their TOR's uplink queue (the
    ECMP hash, or ``faults.select_uplink``), after the fault layer's
    transmit-side losses. ``cm`` is each host's chosen message, ``(B,
    H)`` int32; ``fx`` the slot's fault plan row (``faults.plan_row``).
    Returns updated state."""
    fab = cfg.fabric
    B, H = dsts.shape
    rs = fab.rack_size(H)
    n_up = fab.n_uplinks(H)
    src_rack = torch.arange(H, dtype=I32, device=dsts.device) // rs
    dst_rack = dsts.clamp_max(H - 1) // rs
    local = has & (src_rack == dst_rack)
    remote = has & (src_rack != dst_rack)
    if fab.routing == "ecmp":
        urow = src_rack * n_up + S["spine"].gather(1, cm.long())
    with fault_span(cfg, "slot.faults"):
        if fab.routing != "ecmp":
            urow = select_uplink(cfg, st, cm, src_rack, fx)
        if fab.faults is not None:
            local, remote, st = inject_losses(cfg, st, cm, local, remote,
                                              dsts, urow, now, fx)
    seq = now.expand(B, H)

    r_msg, r_prio, r_seq, r_valid, d_drop = ring_insert(
        st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
        dsts, local, cm, prio_chunk, seq, backend=cfg.backend)
    u_msg, u_prio, u_seq, u_valid, u_drop = ring_insert(
        st["u_msg"], st["u_prio"], st["u_seq"], st["u_valid"],
        urow, remote, cm, prio_chunk, seq, backend=cfg.backend)

    return {**st,
            "r_msg": r_msg, "r_prio": r_prio, "r_seq": r_seq,
            "r_valid": r_valid,
            "u_msg": u_msg, "u_prio": u_prio, "u_seq": u_seq,
            "u_valid": u_valid,
            "lost": st["lost"] + d_drop,
            "u_lost": st["u_lost"] + u_drop}


def uplink_drain(cfg, st, S, now, pre=None, fx=None):
    """Drain at most one chunk per TOR uplink (strict priority, FIFO
    within level) and forward it across its spine into the destination
    downlink ring, where it becomes eligible after ``spine_delay_slots``.
    Returns updated state.

    ``pre`` is an optional pre-solved ``(slot_idx, any_e, prio)`` winner
    triple from the ``fused`` backend, which arbitrates all of a slot's
    stages in one kernel at slot start (DESIGN.md §11). The hoist is
    bit-identical because this slot's ``route_chunks`` insertions carry
    ``u_seq == now`` and ``leaf_delay_slots >= 1`` (enforced by
    ``sim._fused_precompute``) keeps them ineligible until the next slot
    — and ``ring_insert`` never overwrites a valid (winning) slot. ``fx``
    is the slot's fault plan row."""
    fab = cfg.fabric
    H = cfg.n_hosts
    M = S["size"].shape[1]
    B, U = st["u_valid"].shape[:2]

    eligible = st["u_valid"] & (st["u_seq"] + fab.leaf_delay_slots <= now)
    fl = fab.faults
    if fl is not None and (fl.link_fail or fl.tor_fail):
        # a failed uplink black-holes its queue for the window: chunks
        # already buffered there neither drain nor get re-routed
        eligible = eligible & ~fx["link_down"][:, None]
    if pre is not None:
        slot_idx, any_e, _ = pre
    else:
        slot_idx, any_e, _ = drain_select(st["u_prio"], st["u_seq"],
                                          eligible, backend=cfg.backend)
    msg = torch.where(any_e, take_slot(st["u_msg"], slot_idx), M)
    prio = take_slot(st["u_prio"], slot_idx)
    u_valid = clear_slot(st["u_valid"], slot_idx, any_e)

    # forward into the downlink ring with a *virtual* enqueue time such
    # that (seq + net_delay_slots <= t) fires at t = now + spine_delay:
    # the downlink's single eligibility rule then covers both tiers, and
    # FIFO order within a priority level remains arrival-time order at
    # the destination TOR.
    dst = torch.where(any_e, S["dst"].gather(1, msg.clamp_max(M - 1).long()),
                      H)
    vseq = (now + (fab.spine_delay_slots - cfg.net_delay_slots)).expand(B, U)
    ins_ok = any_e
    if fl is not None and (fl.down_loss > 0 or fl.tor_fail):
        # last-hop loss point: the chunk left the uplink (it still counts
        # toward u_busy) but dies on the spine->TOR->host leg
        with fault_span(cfg, "slot.faults"):
            ins_ok, st = forward_losses(cfg, st, msg, dst, any_e, now, fx)
    r_msg, r_prio, r_seq, r_valid, d_drop = ring_insert(
        st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
        dst, ins_ok, msg, prio, vseq, backend=cfg.backend)

    qlen = eligible.sum(dim=2, dtype=I32) - any_e.to(I32)
    out = {**st,
           "r_msg": r_msg, "r_prio": r_prio, "r_seq": r_seq,
           "r_valid": r_valid, "u_valid": u_valid,
           "lost": st["lost"] + d_drop,
           "u_busy": st["u_busy"] + any_e.to(I32),
           "u_q_sum": st["u_q_sum"] + qlen.to(torch.float32),
           "u_q_max": torch.maximum(st["u_q_max"], qlen)}
    if cfg.trace_on:
        # telemetry tap (DESIGN.md §8): running uplink-tier per-priority
        # drain counter, sampled into the strided series by capture_slot
        dp = torch.where(any_e, prio.clamp_max(cfg.n_prios - 1), 0)
        out["tr_uprio_c"] = st["tr_uprio_c"].scatter_add(
            1, dp.long(), any_e.to(I32))
    return out


__all__ = ["FabricConfig", "FaultConfig", "ROUTING_POLICIES", "spine_hash",
           "ring_insert", "ring_drain_select", "drain_select", "take_slot", "clear_slot",
           "init_fabric_state", "route_chunks", "uplink_drain"]
