"""The plain reference of the slotted simulator on a lossy, failing
fabric, for deciding ``correct`` in a cell with a fault layer.

It steps what ``plain_sim.py`` steps (Homa and pFabric on the leaf-spine
fabric; it reuses that file's allocation, statics, rings, drains, grants
and streaming fold unchanged) and adds the paper's loss recovery (Homa,
arXiv:1803.09615 Sec. 3.7) with the fault layer as DESIGN.md Sec. 7
states it:

* draws: every random choice is a counter hash of (row, slot, seed,
  a salt a draw site) mapped to a float32 in [0, 1]. Nothing about them
  depends on the traffic, so they are made before the loop for every
  slot of a run at once, in numpy's uint32 (which wraps as the hash
  wants), and compared with each probability in float32 there;
* the Gilbert-Elliott chain: one good/bad state an uplink, one drawn
  transition a slot (``ge_p_gb`` good to bad, ``ge_p_bg`` back) before
  that slot's loss draws; it too depends on the draws alone;
* the three loss points: a chunk a host sends draws once, and dies at
  uplink enqueue with ``up_loss`` (``up_loss + ge_loss`` while its
  uplink is bad) or, switched within its rack, at downlink enqueue with
  ``down_loss``; a chunk leaving an uplink dies on the spine-to-host leg
  with ``down_loss`` after it spent its uplink slot;
* failure windows, half-open ``[start, end)`` slots: a dark uplink drops
  what enters it and drains nothing (its queue survives); a dark TOR
  darkens its uplinks, kills what its hosts send and what is switched or
  forwarded to them, and its hosts' downlinks drain nothing;
* flowlet routing: a cross-rack chunk's uplink is the hash of (message,
  slot // ``flowlet_slots``) under the fabric's seed, so a flow leaves a
  dark spine at the next epoch;
* recovery, at the end of each slot: a message that has arrived, is
  incomplete and has sent chunks not yet received is quiet since its
  last chunk drained, its last rewind or its arrival. Homa's receiver
  RESENDs a message it has heard from once quiet ``resend_slots``; any
  sender falls back once quiet ``sender_timeout_slots``. Either rewinds
  ``sent`` to ``recv`` and counts the difference as retransmitted
  (``retx``); each run counts its rewinds by trigger, RESEND first when
  both fire (``rw_resend``, ``rw_timeout``). Fault drops are counted per
  message (``msg_lost``, ``first_loss``) and per run (``f_lost``).

It imports nothing of the port or of JAX. :func:`check_supported`
refuses what it does not model: another protocol, the single switch,
adaptive routing, a host stage and telemetry.

Entry points: :func:`run` (``plain_sim.run``'s signature and rows, plus
``f_lost``, ``retx``, ``rw_resend`` and ``rw_timeout`` where faults are
on) and :func:`final_state` (one table through the whole loop, for
holding the reference to the JAX package's goldens).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench import harness

P = harness.load_module("reference", "plain_sim",
                        Path(__file__).resolve().parents[1])
allocate, grant_k, n_sched, n_uplinks = (P.allocate, P.grant_k, P.n_sched,
                                         P.n_uplinks)
I32, BIG = P.I32, P.BIG
ROUTINGS = ("ecmp", "flowlet")
# the fault layer's keys and their values where a configuration omits one
FAULT_DEFAULTS = {"up_loss": 0.0, "down_loss": 0.0, "ge_p_gb": 0.0,
                  "ge_p_bg": 0.05, "ge_loss": 0.5, "link_fail": (),
                  "tor_fail": (), "resend_slots": 300,
                  "sender_timeout_slots": 760, "seed": 0}
# a salt a draw site, so the draws of one row and slot are independent
SALT_CHUNK, SALT_GE, SALT_FWD, SALT_FLOWLET = (0x1B56C4E9, 0x60BEE0D1,
                                               0x7FEB352D, 0x46D9F3B3)


# ================================================================ draws ==

def faults_of(cfg: dict) -> dict | None:
    fl = cfg["fabric"].get("faults")
    return None if fl is None else {**FAULT_DEFAULTS, **fl}


def hash32(a, b, seed: int, salt: int) -> np.ndarray:
    """The counter hash of integer arrays ``a`` and ``b`` (broadcast),
    as uint32: a multiply-xorshift mix."""
    a = np.asarray(a, np.int64).astype(np.uint32)
    b = np.asarray(b, np.int64).astype(np.uint32)
    key = np.uint32(((seed * 0x27D4EB2F) ^ salt) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        h = a * np.uint32(0x9E3779B1) ^ b * np.uint32(0x85EBCA77) ^ key
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x2C1B3C6D)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0x297A2D39)
        return h ^ (h >> np.uint32(16))


def uniform(a, b, seed: int, salt: int) -> np.ndarray:
    """float32 draws in [0, 1]: the hash rounded once to float32 (by
    way of float64, where a uint32 is exact) times 2**-32."""
    h = hash32(a, b, seed, salt)
    return h.astype(np.float64).astype(np.float32) * np.float32(2.0 ** -32)


def draws(cfg: dict, M: int, T: int, device) -> dict:
    """Every slot's loss decisions and masks of slots ``[0, T)``, shared by
    every run of the fabric (tensors with a leading slot axis), and
    under flowlet routing each epoch's uplink of every message."""
    fab, H = cfg["fabric"], cfg["n_hosts"]
    n_up = n_uplinks(cfg)
    U, rs = fab["racks"] * n_up, H // fab["racks"]
    fl = faults_of(cfg)
    t = np.arange(T)[:, None]
    out = {}
    if fl is not None:
        f32 = np.float32
        hosts, ups = np.arange(H)[None], np.arange(U)[None]
        u = uniform(hosts, t, fl["seed"], SALT_CHUNK)
        u_ge = uniform(ups, t, fl["seed"], SALT_GE)
        bad = np.zeros((T, U), bool)
        if fl["ge_p_gb"] > 0:
            state = np.zeros(U, bool)
            for k in range(T):
                state = np.where(state, u_ge[k] >= f32(fl["ge_p_bg"]),
                                 u_ge[k] < f32(fl["ge_p_gb"]))
                bad[k] = state
        host_down = np.zeros((T, H), bool)
        link_down = np.zeros((T, U), bool)
        for r, s, e in fl["tor_fail"]:
            dark = (t >= s) & (t < e)
            host_down |= dark & (hosts // rs == r)
            link_down |= dark & (ups // n_up == r)
        for up, s, e in fl["link_fail"]:
            link_down |= (t >= s) & (t < e) & (ups == up)
        out.update(
            lose_up=u < f32(fl["up_loss"]),
            lose_up_bad=u < f32(fl["up_loss"]) + f32(fl["ge_loss"]),
            lose_down=u < f32(fl["down_loss"]),
            lose_fwd=uniform(ups, t, fl["seed"], SALT_FWD)
            < f32(fl["down_loss"]),
            ge_bad=bad, host_down=host_down, link_down=link_down)
    if fab["routing"] == "flowlet":
        epochs = np.arange((T - 1) // fab["flowlet_slots"] + 1)[:, None]
        out["flowlet"] = (hash32(np.arange(M)[None], epochs, fab["seed"],
                                 SALT_FLOWLET) % np.uint32(n_up)
                          ).astype(np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def slot_row(cfg: dict, plan: dict, t: int) -> dict:
    """Slot ``t``'s rows of :func:`draws` (views)."""
    row = {k: v[t] for k, v in plan.items() if k != "flowlet"}
    if "flowlet" in plan:
        row["flowlet"] = plan["flowlet"][t // cfg["fabric"]["flowlet_slots"]]
    return row


# ================================================================ loop ==

def init_state(cfg: dict, M: int, B: int, device) -> dict:
    st = P.init_state(cfg, M, B, device)
    if faults_of(cfg) is not None:
        def z(*shape):
            return torch.zeros((B, *shape), dtype=I32, device=device)
        st.update(retx=z(M), msg_lost=z(M), last_arr=z(M), last_rw=z(M),
                  first_loss=torch.full((B, M), BIG, dtype=I32,
                                        device=device),
                  f_lost=z(), rw_resend=z(), rw_timeout=z())
    return st


def _count_drops(st, msg, drop, now):
    """Chunks the faults dropped, ``drop`` ``(B, n)`` of messages ``msg``
    (the sentinel M where nothing was sent or drained)."""
    return {**st,
            "msg_lost": P._scatter(st["msg_lost"], msg, drop.to(I32), drop,
                                   "sum"),
            "first_loss": P._scatter(st["first_loss"], msg,
                                     now.expand(msg.shape), drop, "amin"),
            "f_lost": st["f_lost"] + drop.sum(dim=1, dtype=I32)}


def _route(cfg, st, S, cm, has, dsts, prio_chunk, now, fx):
    """Each host's chunk to its downlink ring (same rack) or its uplink
    (the message's ECMP or flowlet spine), past the first loss points."""
    fab, H = cfg["fabric"], cfg["n_hosts"]
    B = dsts.shape[0]
    rs, n_up = H // fab["racks"], n_uplinks(cfg)
    src_rack = torch.arange(H, dtype=I32, device=dsts.device) // rs
    same = src_rack == dsts.clamp_max(H - 1) // rs
    local, remote = has & same, has & ~same
    cml = cm.long()
    spine = (S["spine"].gather(1, cml) if fab["routing"] == "ecmp"
             else fx["flowlet"][cml].to(I32))
    urow = src_rack * n_up + spine
    if "lose_up" in fx:
        up = urow.long()
        dark = fx["host_down"]
        lose_r = (torch.where(fx["ge_bad"][up], fx["lose_up_bad"],
                              fx["lose_up"])
                  | dark | fx["link_down"][up])
        lose_l = fx["lose_down"] | dark | dark[dsts.clamp_max(H - 1).long()]
        st = _count_drops(st, cm, (local & lose_l) | (remote & lose_r), now)
        local, remote = local & ~lose_l, remote & ~lose_r
    seq = now.expand(B, H)
    r = P.ring_insert(st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
                      dsts, local, cm, prio_chunk, seq)
    u = P.ring_insert(st["u_msg"], st["u_prio"], st["u_seq"], st["u_valid"],
                      urow, remote, cm, prio_chunk, seq)
    return {**st, "r_msg": r[0], "r_prio": r[1], "r_seq": r[2],
            "r_valid": r[3], "u_msg": u[0], "u_prio": u[1], "u_seq": u[2],
            "u_valid": u[3], "lost": st["lost"] + r[4],
            "u_lost": st["u_lost"] + u[4]}


def _uplink_drain(cfg, st, S, now, fx, early):
    """One chunk an uplink that is not dark, forwarded toward its
    destination's downlink past the last loss point."""
    fab, H = cfg["fabric"], cfg["n_hosts"]
    M = S["size"].shape[1]
    B, U = st["u_valid"].shape[:2]
    eligible = st["u_valid"] & (st["u_seq"] + fab["leaf_delay_slots"]
                                - early <= now)
    if "link_down" in fx:
        eligible = eligible & ~fx["link_down"][:, None]
    slot_idx, any_e, _ = P.drain_select(st["u_prio"], st["u_seq"], eligible)
    msg = torch.where(any_e, P.take_slot(st["u_msg"], slot_idx), M)
    prio = P.take_slot(st["u_prio"], slot_idx)
    u_valid = P.clear_slot(st["u_valid"], slot_idx, any_e)
    dst = torch.where(any_e, S["dst"].gather(1, msg.clamp_max(M - 1).long()),
                      H)
    vseq = (now + (fab["spine_delay_slots"]
                   - cfg["net_delay_slots"])).expand(B, U)
    ok = any_e
    if "lose_fwd" in fx:
        lose = fx["lose_fwd"] | fx["host_down"][dst.clamp_max(H - 1).long()]
        st = _count_drops(st, msg, any_e & lose, now)
        ok = any_e & ~lose
    r = P.ring_insert(st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
                      dst, ok, msg, prio, vseq)
    return {**st, "r_msg": r[0], "r_prio": r[1], "r_seq": r[2],
            "r_valid": r[3], "u_valid": u_valid, "lost": st["lost"] + r[4],
            "u_busy": st["u_busy"] + any_e.to(I32)}


def _recover(cfg, st, S, now, drained, any_elig):
    """The end of the slot: RESENDs and sender fallbacks rewind quiet
    messages."""
    fl = faults_of(cfg)
    last_arr = P.amax_drop(st["last_arr"], drained, now.expand(
        drained.shape), any_elig)
    waiting = ((S["arrival"] <= now) & (st["completion"] < 0)
               & (st["sent"] > st["recv"]))
    quiet = now - torch.maximum(torch.maximum(last_arr, st["last_rw"]),
                                S["arrival"])
    resend = (st["recv"] > 0) & (quiet >= fl["resend_slots"])
    if cfg["protocol"] != "homa":        # pFabric's receivers schedule none
        resend = torch.zeros_like(resend)
    fire = waiting & (resend | (quiet >= fl["sender_timeout_slots"]))
    return {**st, "last_arr": last_arr,
            "retx": st["retx"] + torch.where(fire, st["sent"] - st["recv"],
                                             0),
            "sent": torch.where(fire, st["recv"], st["sent"]),
            "last_rw": torch.where(fire, now, st["last_rw"]),
            "rw_resend": st["rw_resend"]
            + (fire & resend).sum(dim=1, dtype=I32),
            "rw_timeout": st["rw_timeout"]
            + (fire & ~resend).sum(dim=1, dtype=I32)}


def step(cfg, S, ns, alloc, st, now, fx, early=0):
    """One slot of B runs: grants, senders, the first queueing tier and
    its loss points, the uplinks, the downlinks, the counters, recovery.
    ``fx`` is the slot's :func:`slot_row`; ``early`` slots come off every
    link delay (the control)."""
    H, Dg = cfg["n_hosts"], cfg["grant_delay_slots"]
    B, M = S["size"].shape

    # 1. receivers, through the grant delay line
    grant_r, sched_prio, withheld = P._grants(cfg, st, S, now, ns, alloc)
    row = (now % Dg).long().view(1)
    hist_grant = st["hist_grant"].index_copy(1, row, grant_r[:, None])
    hist_prio = st["hist_prio"].index_copy(1, row, sched_prio[:, None])
    vis = ((now + 1) % Dg).long().view(1)
    arrived = S["arrival"] <= now
    granted_s = torch.maximum(
        torch.maximum(st["granted_s"], torch.where(arrived, S["unsched"],
                                                   0)),
        hist_grant.index_select(1, vis)[:, 0])
    st = {**st, "grant_r": grant_r, "granted_s": granted_s,
          "hist_grant": hist_grant, "hist_prio": hist_prio,
          "sched_prio": torch.where(
              arrived, hist_prio.index_select(1, vis)[:, 0], sched_prio)}

    # 2. senders: one chunk a host by the policy's order
    size, src = S["size"], S["src"]
    sendable = arrived & (st["sent"] < st["granted_s"]) & (st["sent"] < size)
    remaining = (size - st["sent"]).clamp_min(0)
    key = torch.where(sendable,
                      (remaining.clamp_max(P.ORDER_CAP) << P.MSG_BITS)
                      | S["msg_ids"], BIG)
    host_min = torch.full((B, H), BIG, dtype=I32,
                          device=key.device).scatter_reduce_(
        1, src.long(), key, "amin", include_self=True)
    has = host_min < BIG
    cm = torch.where(has, host_min & (P.MSG_MOD - 1),
                     P.MSG_MOD).clamp_max(M - 1)
    cml = cm.long()
    unsched_chunk = st["sent"].gather(1, cml) < S["unsched"].gather(1, cml)
    prio_chunk = P._chunk_prio(cfg, st, S, cml, unsched_chunk, ns)
    has_i = has.to(I32)
    st = {**st, "sent": st["sent"].scatter_add(1, cml, has_i),
          "uplink_busy": st["uplink_busy"] + has_i}

    # 3. the leaf or the TOR uplinks, then the uplink drain
    dsts = torch.where(has, S["dst"].gather(1, cml), H)
    st = _route(cfg, st, S, cm, has, dsts, prio_chunk, now, fx)
    st = _uplink_drain(cfg, st, S, now, fx, early)

    # 4. downlinks not behind a dark TOR: strict priority, FIFO within a
    # level
    eligible = st["r_valid"] & (st["r_seq"] + cfg["net_delay_slots"]
                                - early <= now)
    if "host_down" in fx:
        eligible = eligible & ~fx["host_down"][:, None]
    slot_idx, any_elig, pmin = P.drain_select(st["r_prio"], st["r_seq"],
                                              eligible)
    drained = torch.where(any_elig, P.take_slot(st["r_msg"], slot_idx), M)
    any_i = any_elig.to(I32)
    recv = st["recv"].scatter_add(1, drained.clamp_max(M - 1).long(), any_i)
    r_valid = P.clear_slot(st["r_valid"], slot_idx, any_elig)
    completion = torch.where((recv >= size) & (st["completion"] < 0), now,
                             st["completion"])

    # 5. counters
    qlen = eligible.sum(dim=2, dtype=I32) - any_i
    dprio = torch.where(any_elig, pmin.clamp_max(cfg["n_prios"] - 1), 0)
    known_inc = (recv > 0) & (completion < 0)
    has_known = (S["dst_onehot"] & known_inc[:, None, :]).any(dim=2)
    st = {**st, "recv": recv, "r_valid": r_valid, "completion": completion,
          "busy": st["busy"] + any_i,
          "q_sum": st["q_sum"] + qlen.to(torch.float32),
          "q_max": torch.maximum(st["q_max"], qlen),
          "wasted": st["wasted"] + (~any_elig & withheld
                                    & has_known).to(I32),
          "prio_drained": st["prio_drained"].scatter_add(
              1, dprio.long(), any_i)}

    # 6. loss recovery
    if "lose_up" in fx:
        st = _recover(cfg, st, S, now, drained, any_elig)
    return st


def _steps(cfg, S, ns, alloc, st, plan, lo, hi, early):
    now = torch.full((), lo, dtype=I32, device=S["size"].device)
    for t in range(lo, hi):
        st = step(cfg, S, ns, alloc, st, now, slot_row(cfg, plan, t), early)
        now = now + 1
    return st


# ============================================================== entries ==

def check_supported(cfg: dict) -> None:
    """Raise unless this reference models the configuration."""
    fab = cfg.get("fabric")
    why = []
    if cfg["protocol"] not in P.PROTOCOLS:
        why.append(f"protocol {cfg['protocol']!r}")
    if cfg.get("host") is not None:
        why.append("a host stage")
    if cfg.get("trace") is not None:
        why.append("telemetry")
    if fab is None:
        why.append("the single switch")
    else:
        if fab.get("routing") not in ROUTINGS:
            why.append(f"routing {fab.get('routing')!r}")
        extra = set(fab.get("faults") or ()) - set(FAULT_DEFAULTS)
        if extra:
            why.append(f"fault keys {sorted(extra)}")
    if why:
        raise ValueError("the lossy_sim reference does not model "
                         + ", ".join(why))


def summary(cfg, st, acc) -> dict:
    """``plain_sim``'s integers of every run of the batch, and the fault
    layer's where it is on."""
    out = P.summary(cfg, st, acc)
    if faults_of(cfg) is not None:
        extra = {"f_lost": st["f_lost"], "retx": st["retx"].sum(dim=1),
                 "rw_resend": st["rw_resend"],
                 "rw_timeout": st["rw_timeout"]}
        out.update({k: v.cpu().numpy() for k, v in extra.items()})
    return out


def run(cfg: dict, tables: list[dict], stream: dict, chunk: int | None,
        shared_alloc: bool, runs: list[int], device, block: int = 32,
        early: int = 0) -> list[dict]:
    """The integer outputs of runs ``runs`` of the sweep over ``tables``,
    ``block`` runs at a time, as ``plain_sim.run``."""
    check_supported(cfg)
    rtt_bytes = cfg["rtt_slots"] * cfg["slot_bytes"]
    shared = allocate(np.concatenate([t["size"] for t in tables]),
                      rtt_bytes, cfg["n_prios"]) if shared_alloc else None
    allocs = {i: shared or allocate(tables[i]["size"], rtt_bytes,
                                    cfg["n_prios"]) for i in runs}
    out = {}
    with torch.inference_mode():
        groups: dict = {}
        for i in runs:
            key = (len(tables[i]["size"]), n_sched(cfg, allocs[i]))
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            for b0 in range(0, len(idxs), block):
                part = idxs[b0:b0 + block]
                rows = _run_block(cfg, [tables[i] for i in part],
                                  [allocs[i] for i in part], stream, chunk,
                                  device, early)
                for k, i in enumerate(part):
                    out[i] = {key: v[k] for key, v in rows.items()}
                    out[i]["n_unsched"] = allocs[i]["n_unsched"]
                    out[i]["cutoffs"] = np.asarray(allocs[i]["cutoffs"],
                                                   np.int64)
    return [out[i] for i in runs]


def _stack(cfg, tables, allocs, device):
    Ss = [P.statics(cfg, t, a, device) for t, a in zip(tables, allocs)]
    return {k: torch.stack([s[k] for s in Ss]) for k in Ss[0]}


def _run_block(cfg, tables, allocs, stream, chunk, device, early):
    S = _stack(cfg, tables, allocs, device)
    B, M = S["size"].shape
    ns = n_sched(cfg, allocs[0])
    edges_sz = np.asarray(stream["size_edges"], np.int64)
    szb = np.stack([np.searchsorted(edges_sz, t["size"], side="right")
                    for t in tables])
    counted = np.arange(M) >= int(M * stream["warmup_frac"])
    aux = {"szb": torch.from_numpy(szb.astype(np.int64)).to(device),
           "counted": torch.from_numpy(np.broadcast_to(
               counted, (B, M)).copy()).to(device)}
    edges = torch.from_numpy(P.bucket_edges(stream)).to(device)
    acc = torch.zeros((B, (len(edges_sz) + 1) * stream["n_buckets"]),
                      dtype=I32, device=device)
    st = init_state(cfg, M, B, device)
    ms = cfg["max_slots"]
    plan = draws(cfg, M, ms, device)
    stride = chunk if chunk and chunk < ms else ms
    for lo in range(0, ms, stride):
        hi = min(lo + stride, ms)
        st = _steps(cfg, S, ns, allocs[0], st, plan, lo, hi, early)
        acc = P._fold(stream, edges, acc, st, S, aux, lo, hi)
    return summary(cfg, st, acc)


def final_state(cfg: dict, table: dict, device="cpu") -> dict:
    """One table through ``cfg["max_slots"]`` slots with its own priority
    allocation, as one simulation: the final state of its run, on the
    host."""
    check_supported(cfg)
    alloc = allocate(table["size"], cfg["rtt_slots"] * cfg["slot_bytes"],
                     cfg["n_prios"])
    with torch.inference_mode():
        S = _stack(cfg, [table], [alloc], device)
        M = S["size"].shape[1]
        st = init_state(cfg, M, 1, device)
        plan = draws(cfg, M, cfg["max_slots"], device)
        st = _steps(cfg, S, n_sched(cfg, alloc), alloc, st, plan, 0,
                    cfg["max_slots"], 0)
    return {k: v[0].cpu().numpy() for k, v in st.items()}
