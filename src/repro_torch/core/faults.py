"""Fault injection, loss recovery and spine routing (DESIGN.md §7), in
PyTorch — the port of ``repro.core.faults``.

Three composable pieces, configured on :class:`FabricConfig`:

**1. Loss and failure injection** (:class:`FaultConfig`): Bernoulli chunk
loss on the TOR uplinks (``up_loss``) and at the destination downlink
(``down_loss``); Gilbert–Elliott burst loss per uplink (a good/bad Markov
chain adding ``ge_loss`` while bad); scheduled ``link_fail`` /
``tor_fail`` windows, half-open ``[start, end)`` in slots.

**2. Loss recovery** (:func:`apply_recovery` and
``ReceiverPolicy.resend``): a RESEND rewinds a quiet message's ``sent``
to ``recv`` and credits the difference to ``retx``; Homa's and pHost's
receivers resend-poll after ``resend_slots`` of quiet, every protocol's
sender falls back after ``sender_timeout_slots``.

**3. Spine routing** (``FabricConfig.routing``): ``"ecmp"`` (the static
per-message hash of ``fabric.spine_hash``), ``"flowlet"`` (that message
re-hashed every ``flowlet_slots``) and ``"adaptive"`` (the least-occupied
live uplink of the sender's rack, ties to the lowest).

**Draws.** Every random choice is a counter-based hash of ``(row, slot,
seed, salt)``, as in the JAX package, so runs are bit-reproducible on
every backend and in batched sweeps. The hash is uint32 arithmetic,
which torch supports only in part: the port computes it in int64 on
values in ``[0, 2**32)``, masking after every step, and splits each
multiply by a 32-bit constant into its 16-bit halves so that no partial
product reaches ``2**48`` — nothing relies on signed wrap-around, on the
CPU or on a card. The hash becomes a float32 uniform by one correctly
rounded conversion (a uint32 is exact in int64 and in float64, so every
route rounds once, to nearest) times ``2**-32``: a hash of
``0xFFFFFFFF`` gives 1.0, as in JAX. JAX compares the draw with a
probability given as a Python float, which it rounds to float32; the port
rounds each probability to float32 on the host (:func:`_f32`), so a
comparison in float32 or in float64 gives the same answer.

**Slot plans.** What the fault layer draws depends only on the slot and
the row (host, uplink or message), never on the state: the loss draws,
the Gilbert–Elliott transition draws, the failure windows' masks and the
flowlet hashes. :func:`slot_plan` computes them for a block of slots in
one vectorized pass on the device, and the loop reads its slot's row as a
view (:func:`plan_row`): no device operation a slot, where hashing in the
loop would cost some 35 small operations per draw site.

**Spans and counters.** Where the fault layer is on, a profiled slot
holds the slot span ``slot.faults`` around the transmit-side losses,
the Gilbert–Elliott step, the forwarding losses and the non-ECMP uplink
choice, and ``slot.recovery`` around :func:`apply_recovery`
(:func:`fault_span`); ``run_slots`` records each block's plan as the
call span ``faults.plan``. The state counts, per run, the rewinds fired
by a receiver's RESEND (``rw_resend``) and by the sender fallback
(``rw_timeout``): :data:`REWIND_KEYS`, which the JAX package's state
does not carry.

``FabricConfig.faults=None`` (the default) keeps every tensor, span and
operation of this module out of the loop: zero-fault runs are
bit-identical to the fault-free simulator (both goldens).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.core.protocols import BIG, I32
from repro_torch.core.scatter import add_drop, amin_drop

# the port's per-run rewind counters: state keys the JAX package lacks
REWIND_KEYS = ("rw_resend", "rw_timeout")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Loss/failure/recovery parameters (hashable: rides the frozen
    :class:`FabricConfig`). All probabilities are per chunk per slot."""
    up_loss: float = 0.0            # Bernoulli loss at TOR uplink enqueue
    down_loss: float = 0.0          # Bernoulli loss at downlink enqueue
    ge_p_gb: float = 0.0            # Gilbert-Elliott good->bad per slot
    ge_p_bg: float = 0.05           # Gilbert-Elliott bad->good per slot
    ge_loss: float = 0.5            # extra uplink loss while in bad state
    # scheduled failure windows, half-open [start, end) in slots:
    link_fail: tuple[tuple[int, int, int], ...] = ()   # (uplink, s, e)
    tor_fail: tuple[tuple[int, int, int], ...] = ()    # (rack, s, e)
    # recovery timers (slots of quiet before firing): many RTTs, since an
    # oversubscribed uplink queue can hold a chunk for hundreds of slots
    # and a shorter timer would rewind data still in flight
    resend_slots: int = 300          # receiver RESEND (~8 RTT)
    sender_timeout_slots: int = 760  # sender fallback (~20 RTT)
    seed: int = 0                   # loss-draw hash seed

    def __post_init__(self):
        # normalize JSON-deserialized lists into hashable tuples
        object.__setattr__(self, "link_fail", tuple(
            tuple(int(v) for v in w) for w in self.link_fail))
        object.__setattr__(self, "tor_fail", tuple(
            tuple(int(v) for v in w) for w in self.tor_fail))

    @property
    def ge_on(self) -> bool:
        return self.ge_p_gb > 0

    @property
    def any_loss(self) -> bool:
        return (self.up_loss > 0 or self.down_loss > 0 or self.ge_on
                or bool(self.link_fail) or bool(self.tor_fail))

    def validate(self, fab, n_hosts: int) -> None:
        for name in ("up_loss", "down_loss", "ge_loss"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultConfig.{name} must be a "
                                 f"probability in [0, 1], got {p}")
        if not 0.0 <= self.ge_p_gb <= 1.0 or not 0.0 <= self.ge_p_bg <= 1.0:
            raise ValueError("FaultConfig.ge_p_gb/ge_p_bg must be "
                             "probabilities in [0, 1]")
        if self.ge_on and self.ge_p_bg <= 0:
            raise ValueError(
                "FaultConfig.ge_p_bg must be > 0 when ge_p_gb > 0: a "
                "bad link that can never recover black-holes its spine "
                "forever (use a link_fail window for permanent failure)")
        if self.resend_slots < 1 or self.sender_timeout_slots < 1:
            raise ValueError("FaultConfig recovery timeouts must be >= 1 "
                             "slot")
        U = fab.n_uplinks_total(n_hosts)
        for w in self.link_fail:
            if len(w) != 3 or not (0 <= w[0] < U) or w[1] < 0 \
                    or w[2] <= w[1]:
                raise ValueError(
                    f"FaultConfig.link_fail window {w!r} must be "
                    f"(uplink in [0, {U}), start >= 0, end > start)")
        for w in self.tor_fail:
            if len(w) != 3 or not (0 <= w[0] < fab.racks) or w[1] < 0 \
                    or w[2] <= w[1]:
                raise ValueError(
                    f"FaultConfig.tor_fail window {w!r} must be "
                    f"(rack in [0, {fab.racks}), start >= 0, end > start)")


# ------------------------------------------------ counter-based hashing ----
# Distinct draw sites mix a distinct salt into the seed, so co-indexed
# draws (the per-uplink GE transition and forward-loss draw of one slot)
# stay independent.

_SALT_CHUNK = 0x1B56C4E9     # per-host transmit-chunk loss draw
_SALT_GE = 0x60BEE0D1        # per-uplink Gilbert-Elliott transition
_SALT_FWD = 0x7FEB352D       # per-uplink spine->downlink loss draw
_SALT_FLOWLET = 0x46D9F3B3   # flowlet epoch re-hash

_MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """An integer tensor as uint32 values held in int64 (negative int32
    values wrap as JAX's ``astype(uint32)`` wraps them)."""
    return x.to(torch.int64) & _MASK


def _mul_u32(x, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a
    constant ``c`` below ``2**32``: ``c`` splits into 16-bit halves, so
    both partial products stay below ``2**48``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash_u32(a, b, seed: int, salt: int) -> torch.Tensor:
    """The JAX package's xorshift-multiply mix of ``(a, b)`` (integer
    tensors, broadcast), as uint32 values in an int64 tensor."""
    k = ((seed * 0x27D4EB2F) ^ salt) & _MASK
    h = _mul_u32(_u32(a), 0x9E3779B1) ^ _mul_u32(_u32(b), 0x85EBCA77) ^ k
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x2C1B3C6D)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0x297A2D39)
    return h ^ (h >> 16)


def _unit_f32(h) -> torch.Tensor:
    """uint32 hashes (in int64) -> float32 ``float32(h) * 2**-32``, the
    conversion rounded to nearest; ``0xFFFFFFFF`` gives 1.0."""
    return h.to(torch.float32) * 2.0 ** -32


def _uniform01(a, b, seed: int, salt: int) -> torch.Tensor:
    """Deterministic float32 uniforms in [0, 1] keyed by (a, b, seed,
    salt)."""
    return _unit_f32(_hash_u32(a, b, seed, salt))


def _f32(p: float) -> float:
    """A probability rounded to float32, as JAX rounds a Python float
    compared with a float32 array."""
    return float(np.float32(p))


# ---------------------------------------------------- failure windows ------

def _in_window(now, s: int, e: int):
    return (now >= s) & (now < e)


def link_down_mask(cfg, now) -> torch.Tensor:
    """``now.shape + (U,)`` bool: uplinks inside a ``link_fail`` window or
    belonging to a TOR inside a ``tor_fail`` window at slot(s) ``now``."""
    fab = cfg.fabric
    fl = fab.faults
    now = torch.as_tensor(now, device=cfg.device)[..., None]
    U = fab.n_uplinks_total(cfg.n_hosts)
    n_up = fab.n_uplinks(cfg.n_hosts)
    rows = torch.arange(U, dtype=I32, device=now.device)
    down = torch.zeros(now.shape[:-1] + (U,), dtype=torch.bool,
                       device=now.device)
    for (u, s, e) in fl.link_fail:
        down = down | ((rows == u) & _in_window(now, s, e))
    for (r, s, e) in fl.tor_fail:
        down = down | ((rows // n_up == r) & _in_window(now, s, e))
    return down


def host_down_mask(cfg, now) -> torch.Tensor:
    """``now.shape + (H,)`` bool: hosts whose TOR is inside a ``tor_fail``
    window — their downlinks neither accept nor drain chunks, and chunks
    they transmit die at the dead TOR."""
    fab = cfg.fabric
    now = torch.as_tensor(now, device=cfg.device)[..., None]
    H = cfg.n_hosts
    rs = fab.rack_size(H)
    hosts = torch.arange(H, dtype=I32, device=now.device)
    down = torch.zeros(now.shape[:-1] + (H,), dtype=torch.bool,
                       device=now.device)
    for (r, s, e) in fab.faults.tor_fail:
        down = down | ((hosts // rs == r) & _in_window(now, s, e))
    return down


# -------------------------------------------------------- slot plans -------

PLAN_SLOTS = 1024            # slots a plan block covers at most
PLAN_FLOWLET = 1 << 22       # flowlet hashes (epochs x messages) it holds


def plan_needed(cfg) -> bool:
    """True iff a step reads a slot plan: a fault layer, or flowlet
    routing."""
    return cfg.fabric_on and (cfg.fabric.faults is not None
                              or cfg.fabric.routing == "flowlet")


def plan_block(cfg, M: int) -> int:
    """Slots per plan block: :data:`PLAN_SLOTS`, fewer where one flowlet
    row of M hashes per epoch would pass :data:`PLAN_FLOWLET`."""
    if cfg.fabric.routing != "flowlet":
        return PLAN_SLOTS
    F = cfg.fabric.flowlet_slots
    return max(1, min(PLAN_SLOTS, F * (PLAN_FLOWLET // max(M, 1) - 1)))


def _plan(cfg, M: int, t, e) -> dict:
    """The draws and masks of slots ``t`` ``(n,)`` and the flowlet hashes
    of epochs ``e`` ``(E,)`` (int32 tensors on ``cfg.device``)."""
    fab, fl = cfg.fabric, cfg.fabric.faults
    dev = t.device
    plan = {}
    if fl is not None:
        hosts = torch.arange(cfg.n_hosts, dtype=I32, device=dev)
        ups = torch.arange(fab.n_uplinks_total(cfg.n_hosts), dtype=I32,
                           device=dev)
        tc = t[:, None]
        plan["u_chunk"] = _uniform01(hosts, tc, fl.seed, _SALT_CHUNK)
        plan["u_ge"] = _uniform01(ups, tc, fl.seed, _SALT_GE)
        plan["u_fwd"] = _uniform01(ups, tc, fl.seed, _SALT_FWD)
        plan["host_down"] = host_down_mask(cfg, t)
        plan["link_down"] = link_down_mask(cfg, t)
    if fab.routing == "flowlet":
        # a flow pinned to a dead or congested spine escapes at the next
        # epoch boundary; hashed with the fabric's seed, as in JAX
        msgs = torch.arange(M, dtype=I32, device=dev)
        plan["flowlet"] = (_hash_u32(msgs, e[:, None], fab.seed,
                                     _SALT_FLOWLET)
                           % fab.n_uplinks(cfg.n_hosts)).to(I32)
    return plan


def slot_plan(cfg, M: int, start: int, stop: int) -> dict:
    """The plan of slots ``[start, stop)``: per-slot rows ``(n, ·)`` and,
    under flowlet routing, one row of M spine choices per epoch the block
    touches."""
    F = cfg.fabric.flowlet_slots
    t = torch.arange(start, stop, dtype=I32, device=cfg.device)
    e = torch.arange(start // F, (stop - 1) // F + 1, dtype=I32,
                     device=cfg.device)
    return _plan(cfg, M, t, e)


def plan_row(cfg, plan: dict, start: int, t: int) -> dict:
    """Slot ``t``'s row of a plan whose block starts at slot ``start``:
    views, no device operation."""
    row = {k: v[t - start] for k, v in plan.items() if k != "flowlet"}
    if "flowlet" in plan:
        F = cfg.fabric.flowlet_slots
        row["flowlet"] = plan["flowlet"][t // F - start // F]
    return row


# ------------------------------------------------------- loop state --------

def init_fault_state(cfg, M: int, B: int) -> dict:
    """Fault/recovery loop state of B runs; only fault-enabled configs
    carry it."""
    U = cfg.fabric.n_uplinks_total(cfg.n_hosts)
    dev = cfg.device

    def z(*shape):
        return torch.zeros((B, *shape), dtype=I32, device=dev)

    return {
        "retx": z(M),                       # chunks re-credited by rewinds
        "msg_lost": z(M),                   # fault-dropped chunks per msg
        "first_loss": torch.full((B, M), BIG, dtype=I32, device=dev),
        "last_arr": z(M),                   # last slot a chunk drained
        "last_rw": z(M),                    # last rewind slot (backoff)
        "f_lost": z(),                      # total fault-dropped chunks
        "ge_bad": torch.zeros((B, U), dtype=torch.bool, device=dev),
        "rw_resend": z(),                   # rewinds fired by RESEND
        "rw_timeout": z(),                  # rewinds by the sender fallback
    }


def fault_span(cfg, name: str):
    """Slot span ``name`` where the fault layer is on; no span elsewhere,
    so fault-free runs record nothing new."""
    return spans.slot(name) if cfg.faults_on else spans.NOOP


def _record_drops(st, cm, dropped, now):
    """Account fault drops: per-message counts, first-loss slot, total.
    ``cm`` may hold the sentinel M where nothing was dropped; those
    writes go to the spare element (``core/scatter.py``)."""
    return {**st,
            "msg_lost": add_drop(st["msg_lost"], cm, dropped.to(I32),
                                 dropped),
            "first_loss": amin_drop(st["first_loss"], cm,
                                    now.expand(cm.shape), dropped),
            "f_lost": st["f_lost"] + dropped.sum(dim=1, dtype=I32)}


# -------------------------------------------------------- loss points ------

def inject_losses(cfg, st, cm, local, remote, dsts, urow, now, fx):
    """Apply the transmit-side loss points to this slot's chunks: link /
    TOR failure drops, Bernoulli uplink + downlink loss, and
    Gilbert–Elliott burst loss on the chosen uplink. ``local`` /
    ``remote`` are the ``(B, H)`` insert masks of ``route_chunks``,
    ``fx`` the slot's plan row; returns the thinned masks and the
    updated state."""
    fl = cfg.fabric.faults
    H = cfg.n_hosts
    st = advance_ge(cfg, st, fx)
    u = fx["u_chunk"]                                       # (H,)
    lose_l = u < _f32(fl.down_loss)
    if fl.ge_on:
        # p_up = up_loss + ge_loss on a bad uplink, a float32 sum
        p_bad = float(np.float32(fl.up_loss) + np.float32(fl.ge_loss))
        lose_r = torch.where(st["ge_bad"].gather(1, urow.long()),
                             u < p_bad, u < _f32(fl.up_loss))
    else:
        lose_r = u < _f32(fl.up_loss)
    if fl.tor_fail:
        hd = fx["host_down"]
        lose_l = lose_l | hd | hd[dsts.clamp_max(H - 1).long()]
        lose_r = lose_r | hd
    if fl.link_fail or fl.tor_fail:
        lose_r = lose_r | fx["link_down"][urow.long()]
    drop_local = local & lose_l
    drop_remote = remote & lose_r
    st = _record_drops(st, cm, drop_local | drop_remote, now)
    return local & ~drop_local, remote & ~drop_remote, st


def advance_ge(cfg, st, fx):
    """One Gilbert–Elliott transition per uplink per slot (no-op unless
    the chain is enabled)."""
    fl = cfg.fabric.faults
    if not fl.ge_on:
        return st
    ug = fx["u_ge"]
    return {**st, "ge_bad": torch.where(st["ge_bad"],
                                        ug >= _f32(fl.ge_p_bg),
                                        ug < _f32(fl.ge_p_gb))}


def forward_losses(cfg, st, msg, dst, any_e, now, fx):
    """Loss point for chunks leaving an uplink toward the destination
    downlink: ``down_loss`` Bernoulli drops plus dead-destination drops.
    ``msg`` / ``dst`` are ``(B, U)`` with the sentinels M / H where
    nothing drained. Returns the thinned insert mask and the state."""
    fl = cfg.fabric.faults
    lose = fx["u_fwd"] < _f32(fl.down_loss)
    if fl.tor_fail:
        lose = lose | fx["host_down"][dst.clamp_max(cfg.n_hosts - 1)
                                      .long()]
    dropf = any_e & lose
    st = _record_drops(st, msg, dropf, now)
    return any_e & ~dropf, st


# ----------------------------------------------------- spine routing -------

def select_uplink(cfg, st, cm, src_rack, fx):
    """``(B, H)`` absolute uplink row for each host's chosen chunk under
    the non-ECMP routing policies (``route_chunks`` keeps the static ECMP
    path inline)."""
    fab = cfg.fabric
    n_up = fab.n_uplinks(cfg.n_hosts)
    if fab.routing == "flowlet":
        spine = fx["flowlet"][cm.long()]
    elif fab.routing == "adaptive":
        # least-loaded uplink of the sender's rack this slot; failed
        # uplinks are masked out so routing reacts to failures at once
        B = cm.shape[0]
        occ = st["u_valid"].sum(dim=2, dtype=I32)           # (B, U)
        fl = fab.faults
        if fl is not None and (fl.link_fail or fl.tor_fail):
            occ = torch.where(fx["link_down"], BIG, occ)
        # torch.argmin returns the first minimum: ties -> lowest uplink
        best = occ.view(B, fab.racks, n_up).argmin(dim=2)
        spine = best.gather(1, src_rack.long().expand(cm.shape)).to(I32)
    else:  # pragma: no cover - guarded by FabricConfig.validate
        raise ValueError(f"unknown routing policy {fab.routing!r}")
    return src_rack * n_up + spine


# ----------------------------------------------------- loss recovery -------

def apply_recovery(cfg, proto, st, S, now, drained_msg, any_elig):
    """End-of-slot loss recovery: refresh each message's last-arrival
    clock from this slot's drain, then rewind ``sent`` to ``recv`` for
    every message whose quiet period tripped the receiver's RESEND hook
    or the sender fallback timeout. Each run counts its rewinds by
    trigger (``rw_resend``, ``rw_timeout``); RESEND wins when both timers
    fired in the same slot."""
    fl = cfg.fabric.faults
    M = S["size"].shape[1]
    # a host that drained nothing writes 0 at message M-1: a no-op max
    last_arr = st["last_arr"].scatter_reduce(
        1, drained_msg.clamp_max(M - 1).long(),
        torch.where(any_elig, now, 0), "amax", include_self=True)
    missing = (S["arrival"] <= now) & (st["completion"] < 0) \
        & (st["sent"] > st["recv"])
    ref_t = torch.maximum(torch.maximum(last_arr, st["last_rw"]),
                          S["arrival"])
    quiet = now - ref_t
    known = st["recv"] > 0
    resend = proto.receiver.resend(cfg, st, S, now, known, quiet)
    rw = missing & (resend | (quiet >= fl.sender_timeout_slots))
    rewound = torch.where(rw, st["sent"] - st["recv"], 0)
    by_resend, by_timeout = rw & resend, rw & ~resend
    out = {**st,
           "last_arr": last_arr,
           "sent": torch.where(rw, st["recv"], st["sent"]),
           "retx": st["retx"] + rewound,
           "last_rw": torch.where(rw, now, st["last_rw"]),
           "rw_resend": st["rw_resend"] + by_resend.sum(dim=1, dtype=I32),
           "rw_timeout": st["rw_timeout"]
           + by_timeout.sum(dim=1, dtype=I32)}
    if cfg.ledger_on:
        # telemetry tap (DESIGN.md §8): this slot's rewinds split by
        # trigger, read by the event ledger at the end of the slot
        out["tr_resend"] = torch.where(by_resend, rewound, 0)
        out["tr_timeout"] = torch.where(by_timeout, rewound, 0)
    return out


__all__ = ["FaultConfig", "REWIND_KEYS", "link_down_mask", "host_down_mask",
           "init_fault_state", "fault_span", "inject_losses", "advance_ge",
           "forward_losses", "select_uplink", "apply_recovery",
           "slot_plan", "plan_row", "plan_needed", "plan_block"]
