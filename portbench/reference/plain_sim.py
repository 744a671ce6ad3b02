"""The plain reference of the slotted simulator, for deciding ``correct``.

A frozen copy of the port's plain simulator path (``repro_torch.core``:
``priorities``, ``sim.prepare``/``step_fn`` on ``backend="reference"``,
``protocols``, ``fabric``, ``scatter`` and the streaming fold and
summary of ``sweep``), in plain PyTorch and numpy. It imports nothing of
the port or of JAX and takes nothing the program made: it works out the
priority allocation, the unscheduled limits, the per-message statics
and the whole loop state again from the benchmark's own tables.

It models what the benchmark's sweep configurations use: Homa and
pFabric on the ECMP leaf-spine fabric. Another protocol, the single
switch, a fault layer, a host stage, telemetry or another routing policy
needs a reference of its own (``reference`` in the configuration file);
:func:`check_supported` refuses them here.

``early=1`` is the control of the comparison (PERF.md): both drain
tiers see a chunk one slot before its link delay has passed, which
breaks the configuration's stated delays (``net_delay_slots``,
``leaf_delay_slots``, ``spine_delay_slots``) and nothing else: the
fault of a drain hoisted or fused past the stage that makes its chunks
eligible.

Entry point: :func:`run` -> one dict of integer outputs per run asked
for, the fields of a streaming sweep's ``SweepStats`` before they are
turned into fractions.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
BIG = 2 ** 30
MSG_BITS = 13
MSG_MOD = 1 << MSG_BITS
ORDER_CAP = (1 << 17) - 1
PROTOCOLS = ("homa", "pfabric")


# ============================================================ numpy side ==

def equal_bytes_cutoffs(sizes, weights, n_levels: int) -> list[int]:
    if n_levels <= 1:
        return []
    order = np.argsort(sizes, kind="stable")
    s_sorted = sizes[order]
    w_cum = np.cumsum(weights[order])
    total = w_cum[-1]
    cuts = []
    for i in range(1, n_levels):
        idx = int(np.searchsorted(w_cum, total * i / n_levels))
        cuts.append(int(s_sorted[min(idx, len(s_sorted) - 1)]))
    for i in range(1, len(cuts)):
        cuts[i] = max(cuts[i], cuts[i - 1])
    return cuts


def allocate(sizes, unsched_limit: int, n_prios: int) -> dict:
    """Homa's receiver-side priority allocation (paper Sec. 3.4):
    ``{"n_unsched", "n_sched", "cutoffs"}``."""
    sizes = np.asarray(sizes, np.int64)
    unsched = np.minimum(sizes, unsched_limit).astype(np.float64)
    frac = float(unsched.sum() / max(sizes.sum(), 1))
    n_unsched = min(max(int(round(frac * n_prios)), 1), n_prios - 1)
    return {"n_unsched": n_unsched, "n_sched": n_prios - n_unsched,
            "cutoffs": tuple(equal_bytes_cutoffs(sizes, unsched,
                                                 n_unsched))}


def n_sched(cfg: dict, alloc: dict) -> int:
    """Scheduled levels, the loop's static parameter."""
    if cfg["protocol"] == "homa":
        return max(alloc["n_sched"], 1)
    return max(cfg["overcommit"] or alloc["n_sched"], 1)


def grant_k(cfg: dict, alloc: dict) -> int:
    """The receivers' top-K width; 0 for pFabric's window receivers,
    which select no grant set."""
    if cfg["protocol"] == "homa":
        return cfg["overcommit"] or n_sched(cfg, alloc)
    return 0


def _to_slots(nbytes, slot_bytes: int) -> np.ndarray:
    return np.maximum((nbytes + slot_bytes - 1) // slot_bytes,
                      1).astype(np.int32)


def n_uplinks(cfg: dict) -> int:
    """Uplinks a TOR."""
    fab = cfg["fabric"]
    return max(1, int(round(cfg["n_hosts"] // fab["racks"]
                            / fab["oversub"])))


def spine_hash(src, dst, msg_id, seed: int, n_up: int) -> np.ndarray:
    seed_mix = np.uint32((seed * 0x27D4EB2F) & 0xFFFFFFFF)
    h = (np.asarray(src, np.uint32) * np.uint32(0x9E3779B1)
         ^ np.asarray(dst, np.uint32) * np.uint32(0x85EBCA77)
         ^ np.asarray(msg_id, np.uint32) * np.uint32(0xC2B2AE3D)
         ^ seed_mix)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return (h % np.uint32(n_up)).astype(np.int32)


def statics(cfg: dict, table: dict, alloc: dict, device) -> dict:
    """Per-message tensors of one run."""
    H, sb, fab = cfg["n_hosts"], cfg["slot_bytes"], cfg["fabric"]
    sizes = np.asarray(table["size"], np.int64)
    M = len(sizes)
    size_slots = _to_slots(sizes, sb)
    unsched = np.minimum(_to_slots(np.full(M, cfg["rtt_slots"] * sb), sb),
                         size_slots)
    if cfg["protocol"] == "homa":
        lvl = np.searchsorted(np.asarray(alloc["cutoffs"]), sizes, "left")
        uprio = cfg["n_prios"] - 1 - lvl
    else:
        uprio = np.zeros(M)
    # the unloaded time: cross-rack chunks cross leaf and spine
    rs = H // fab["racks"]
    cross = (table["src"] // rs) != (table["dst"] // rs)
    net_delay = np.where(cross, fab["leaf_delay_slots"]
                         + fab["spine_delay_slots"], cfg["net_delay_slots"])
    S = {"src": table["src"], "dst": table["dst"], "size": size_slots,
         "arrival": table["arrival_slot"], "unsched": unsched,
         "uprio": uprio,
         "dst_onehot": np.arange(H)[:, None] == table["dst"][None, :],
         "msg_ids": np.arange(M), "ideal": size_slots + net_delay,
         "spine": spine_hash(table["src"], table["dst"], np.arange(M),
                             fab["seed"], n_uplinks(cfg))}
    out = {}
    for k, v in S.items():
        v = np.ascontiguousarray(v)
        out[k] = torch.from_numpy(v if v.dtype == np.bool_
                                  else v.astype(np.int32)).to(device)
    return out


# ============================================================= scatters ==

def _flat_spare(a):
    return torch.cat([a.reshape(a.shape[0], -1),
                      a.new_zeros((a.shape[0], 1))], dim=1)


def _scatter(a, idx, vals, keep, reduce: str | None):
    """``a[b].flat[idx[b, i]] (op)= vals[b, i]`` where ``keep[b, i]``;
    other writes land on a spare element that is cut off."""
    n = a[0].numel()
    flat = _flat_spare(a)
    tgt = torch.where(keep, idx.long(), n)
    if reduce is None:
        flat.scatter_(1, tgt, vals)
    else:
        flat.scatter_reduce_(1, tgt, vals, reduce, include_self=True)
    return flat[:, :n].reshape(a.shape)


def set_drop(a, idx, vals, keep):
    return _scatter(a, idx, vals, keep, None)


def amax_drop(a, idx, vals, keep):
    return _scatter(a, idx, vals, keep, "amax")


# ================================================================ rings ==

def ring_insert(msg_a, prio_a, seq_a, valid_a, row, ok, msg, prio, seq):
    """Chunks into the first free slots of their rows, in input order;
    dropped only where the row is full. Returns the rings and the
    dropped count a run."""
    B, R, cap = valid_a.shape
    n = row.shape[1]
    rows = torch.where(ok, row, R).long()
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=row.device).tril_(-1)
    rank = ((rows[:, :, None] == rows[:, None, :]) & earlier).sum(dim=2)
    c = torch.cumsum(~valid_a, dim=2)
    c_row = c.gather(1, rows.clamp_max(R - 1)[:, :, None].expand(B, n, cap))
    room = c_row[:, :, -1] > rank
    okw = ok & room
    pos = torch.searchsorted(c_row, (rank + 1)[:, :, None],
                             right=False)[:, :, 0]
    flat = rows * cap + pos
    return (set_drop(msg_a, flat, msg, okw),
            set_drop(prio_a, flat, prio, okw),
            set_drop(seq_a, flat, seq, okw),
            set_drop(valid_a, flat, okw, okw),
            (ok & ~room).sum(dim=1, dtype=I32))


def drain_select(prio_a, seq_a, elig):
    """One chunk a row: strict priority, the oldest (smallest seq)
    within the level, ties to the lowest column. Returns ``(slot_idx,
    any, best prio)``."""
    p = torch.where(elig, prio_a, BIG)
    pmin = p.amin(dim=-1)
    s = torch.where(elig, seq_a, BIG)
    idx = torch.where(p == pmin[..., None], s, BIG).argmin(dim=-1).to(I32)
    return idx, pmin < BIG, pmin


def take_slot(a, slot_idx):
    return a.gather(-1, slot_idx.long()[..., None])[..., 0]


def clear_slot(valid_a, slot_idx, drained):
    si = slot_idx.long()[..., None]
    return valid_a.scatter(-1, si, valid_a.gather(-1, si)
                           & ~drained[..., None])


# ============================================================== policies ==

def _chunk_prio(cfg, st, S, cm, unsched, ns):
    """The wire priority of each host's chunk, smaller first: Homa's
    unscheduled levels above its scheduled band; pFabric's remaining
    size."""
    if cfg["protocol"] == "homa":
        up = cfg["n_prios"] - 1 - S["uprio"].gather(1, cm)
        sp = ns - 1 - st["sched_prio"].gather(1, cm)
        return torch.where(unsched, up, (cfg["n_prios"] - ns) + sp)
    return (S["size"].gather(1, cm) - st["sent"].gather(1, cm)).clamp_min(0)


def _srpt_grants(cfg, st, S, eligible, K, ns):
    """Each receiver's top-K SRPT messages (ties to the smallest message
    id), granted one RTT ahead, shortest on the highest scheduled
    level."""
    size, dst_oh = S["size"], S["dst_onehot"]
    B, M = size.shape
    H = cfg["n_hosts"]
    remaining = (size - st["recv"]).clamp_min(0)
    K = min(K, M)
    keyval = ((ORDER_CAP + 1 - remaining.clamp_max(ORDER_CAP))
              << MSG_BITS) | (MSG_MOD - 1 - S["msg_ids"])
    mat = torch.where(dst_oh & eligible[:, None, :], keyval[:, None, :], 0)
    vals, idx = torch.sort(mat.view(B * H, M), dim=-1, descending=True,
                           stable=True)
    vals = vals[:, :K].clamp_min(0).view(B, H, K)
    idx = idx[:, :K].to(I32).view(B, H, K)
    valid = vals > 0
    idx = torch.where(valid, idx, -1)
    n_active = valid.sum(dim=2, dtype=I32)
    ranks = torch.arange(K, dtype=I32, device=vals.device)
    prio = (n_active[:, :, None] - 1 - ranks).clamp(0, max(ns - 1, 0))
    flat_msgs, flat_valid = idx.reshape(B, -1), valid.reshape(B, -1)
    new_grant = torch.minimum(size, st["recv"] + cfg["rtt_slots"])
    grant_r = amax_drop(
        st["grant_r"], flat_msgs,
        torch.where(flat_valid,
                    new_grant.gather(1, flat_msgs.clamp(0, M - 1).long()),
                    0), flat_valid)
    sched_prio = set_drop(st["sched_prio"], flat_msgs, prio.reshape(B, -1),
                          flat_valid)
    active = set_drop(torch.zeros_like(eligible), flat_msgs, flat_valid,
                      flat_valid)
    withheld = (dst_oh & (eligible & ~active)[:, None, :]).any(dim=2)
    return grant_r, sched_prio, withheld


def _grants(cfg, st, S, now, ns, alloc):
    """Homa's top-K SRPT grants to the messages heard from; pFabric's
    RTT window to every arrived, incomplete message."""
    if cfg["protocol"] == "homa":
        eligible = (st["recv"] > 0) & (st["completion"] < 0)
        return _srpt_grants(cfg, st, S, eligible, grant_k(cfg, alloc), ns)
    gate = (S["arrival"] <= now) & (st["completion"] < 0)
    grant_r = torch.where(gate, torch.minimum(S["size"], st["recv"]
                                              + cfg["rtt_slots"]),
                          st["grant_r"])
    grant_r = torch.maximum(grant_r, st["grant_r"])
    withheld = torch.zeros((gate.shape[0], cfg["n_hosts"]),
                           dtype=torch.bool, device=gate.device)
    return grant_r, torch.zeros_like(st["sched_prio"]), withheld


# ================================================================= loop ==

def init_state(cfg: dict, M: int, B: int, device) -> dict:
    H, cap, Dg = cfg["n_hosts"], cfg["ring_cap"], cfg["grant_delay_slots"]

    def z(*shape):
        return torch.zeros((B, *shape), dtype=I32, device=device)

    def full(v, *shape):
        return torch.full((B, *shape), v, dtype=I32, device=device)

    st = {"sent": z(M), "granted_s": z(M), "grant_r": z(M), "recv": z(M),
          "sched_prio": z(M), "completion": full(-1, M),
          "r_msg": full(-1, H, cap), "r_prio": full(BIG, H, cap),
          "r_seq": full(BIG, H, cap),
          "r_valid": torch.zeros((B, H, cap), dtype=torch.bool,
                                 device=device),
          "hist_grant": z(Dg, M), "hist_prio": z(Dg, M),
          "busy": z(H), "wasted": z(H), "lost": z(),
          "q_sum": torch.zeros((B, H), dtype=torch.float32, device=device),
          "q_max": z(H), "prio_drained": z(cfg["n_prios"]),
          "uplink_busy": z(H)}
    U, ucap = cfg["fabric"]["racks"] * n_uplinks(cfg), cfg["fabric"]["up_cap"]
    st.update(u_msg=full(-1, U, ucap), u_prio=full(BIG, U, ucap),
              u_seq=full(BIG, U, ucap),
              u_valid=torch.zeros((B, U, ucap), dtype=torch.bool,
                                  device=device),
              u_busy=z(U), u_lost=z())
    return st


def _route(cfg, st, S, cm, has, dsts, prio_chunk, now):
    fab, H = cfg["fabric"], cfg["n_hosts"]
    B = dsts.shape[0]
    rs, n_up = H // fab["racks"], n_uplinks(cfg)
    src_rack = torch.arange(H, dtype=I32, device=dsts.device) // rs
    dst_rack = dsts.clamp_max(H - 1) // rs
    local = has & (src_rack == dst_rack)
    remote = has & (src_rack != dst_rack)
    urow = src_rack * n_up + S["spine"].gather(1, cm.long())
    seq = now.expand(B, H)
    r = ring_insert(st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
                    dsts, local, cm, prio_chunk, seq)
    u = ring_insert(st["u_msg"], st["u_prio"], st["u_seq"], st["u_valid"],
                    urow, remote, cm, prio_chunk, seq)
    return {**st, "r_msg": r[0], "r_prio": r[1], "r_seq": r[2],
            "r_valid": r[3], "u_msg": u[0], "u_prio": u[1], "u_seq": u[2],
            "u_valid": u[3], "lost": st["lost"] + r[4],
            "u_lost": st["u_lost"] + u[4]}


def _uplink_drain(cfg, st, S, now, early):
    fab, H = cfg["fabric"], cfg["n_hosts"]
    M = S["size"].shape[1]
    B, U = st["u_valid"].shape[:2]
    eligible = st["u_valid"] & (st["u_seq"] + fab["leaf_delay_slots"]
                                - early <= now)
    slot_idx, any_e, _ = drain_select(st["u_prio"], st["u_seq"], eligible)
    msg = torch.where(any_e, take_slot(st["u_msg"], slot_idx), M)
    prio = take_slot(st["u_prio"], slot_idx)
    u_valid = clear_slot(st["u_valid"], slot_idx, any_e)
    dst = torch.where(any_e, S["dst"].gather(1, msg.clamp_max(M - 1).long()),
                      H)
    vseq = (now + (fab["spine_delay_slots"]
                   - cfg["net_delay_slots"])).expand(B, U)
    r = ring_insert(st["r_msg"], st["r_prio"], st["r_seq"], st["r_valid"],
                    dst, any_e, msg, prio, vseq)
    return {**st, "r_msg": r[0], "r_prio": r[1], "r_seq": r[2],
            "r_valid": r[3], "u_valid": u_valid,
            "lost": st["lost"] + r[4],
            "u_busy": st["u_busy"] + any_e.to(I32)}


def step(cfg, S, ns, alloc, st, now, early=0):
    """One slot of B runs: grants, senders, the first queueing tier, the
    uplinks, the downlinks, the counters. ``early`` slots come off every
    link delay (the control)."""
    H, Dg = cfg["n_hosts"], cfg["grant_delay_slots"]
    B, M = S["size"].shape

    # 1. receivers, through the grant delay line
    grant_r, sched_prio, withheld = _grants(cfg, st, S, now, ns, alloc)
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
                      (remaining.clamp_max(ORDER_CAP) << MSG_BITS)
                      | S["msg_ids"], BIG)
    host_min = torch.full((B, H), BIG, dtype=I32,
                          device=key.device).scatter_reduce_(
        1, src.long(), key, "amin", include_self=True)
    has = host_min < BIG
    cm = torch.where(has, host_min & (MSG_MOD - 1), MSG_MOD).clamp_max(M - 1)
    cml = cm.long()
    unsched_chunk = st["sent"].gather(1, cml) < S["unsched"].gather(1, cml)
    prio_chunk = _chunk_prio(cfg, st, S, cml, unsched_chunk, ns)
    has_i = has.to(I32)
    st = {**st, "sent": st["sent"].scatter_add(1, cml, has_i),
          "uplink_busy": st["uplink_busy"] + has_i}

    # 3. the leaf (same rack) or the TOR uplinks, then the uplink drain
    dsts = torch.where(has, S["dst"].gather(1, cml), H)
    st = _route(cfg, st, S, cm, has, dsts, prio_chunk, now)
    st = _uplink_drain(cfg, st, S, now, early)

    # 4. downlinks: strict priority, FIFO within a level
    eligible = st["r_valid"] & (st["r_seq"] + cfg["net_delay_slots"]
                                - early <= now)
    slot_idx, any_elig, pmin = drain_select(st["r_prio"], st["r_seq"],
                                            eligible)
    drained = torch.where(any_elig, take_slot(st["r_msg"], slot_idx), M)
    any_i = any_elig.to(I32)
    recv = st["recv"].scatter_add(1, drained.clamp_max(M - 1).long(), any_i)
    r_valid = clear_slot(st["r_valid"], slot_idx, any_elig)
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

    return st


# ============================================================ streaming ==

def bucket_edges(stream: dict) -> np.ndarray:
    nb = stream["n_buckets"]
    ratio = stream["max_slowdown"] ** (1.0 / (nb - 1))
    return (ratio ** np.arange(1, nb, dtype=np.float64)).astype(np.float32)


def _fold(stream, edges, acc, st, S, aux, lo, hi):
    nb = stream["n_buckets"]
    comp = st["completion"]
    m = (comp >= lo) & (comp < hi) & aux["counted"]
    sd = (comp - S["arrival"] + 1).to(torch.float32) \
        / S["ideal"].to(torch.float32)
    b = torch.searchsorted(edges, sd, right=True)
    return acc.scatter_add(1, aux["szb"] * nb + b.clamp(0, nb - 1),
                           m.to(I32))


def summary(cfg, st, acc) -> dict:
    """The integer outputs of every run of the batch, on the host."""
    out = {"hist": acc, "n_complete": (st["completion"] >= 0).sum(dim=1),
           "busy": st["busy"].sum(dim=1), "wasted": st["wasted"].sum(dim=1),
           "uplink_busy": st["uplink_busy"].sum(dim=1),
           "q_sum": st["q_sum"].to(torch.float64).sum(dim=1),
           "q_max": st["q_max"].amax(dim=1),
           "prio_drained": st["prio_drained"],
           "lost": st["lost"] + st["u_lost"],
           "u_busy": st["u_busy"].sum(dim=1)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["q_sum"] = np.rint(out["q_sum"]).astype(np.int64)
    return out


def check_supported(cfg: dict) -> None:
    """Raise unless this reference models the configuration."""
    fab = cfg.get("fabric")
    why = []
    if cfg["protocol"] not in PROTOCOLS:
        why.append(f"protocol {cfg['protocol']!r}")
    if cfg.get("host") is not None:
        why.append("a host stage")
    if cfg.get("trace") is not None:
        why.append("telemetry")
    if fab is None:
        why.append("the single switch")
    elif fab.get("faults") is not None or fab.get("routing") != "ecmp":
        why.append("a fault layer or a routing policy other than ecmp")
    if why:
        raise ValueError("the plain_sim reference does not model "
                         + ", ".join(why))


def run(cfg: dict, tables: list[dict], stream: dict, chunk: int | None,
        shared_alloc: bool, runs: list[int], device, block: int = 32,
        early: int = 0) -> list[dict]:
    """The integer outputs of runs ``runs`` of the sweep over ``tables``,
    ``block`` runs at a time: the allocation is worked out over every
    table when ``shared_alloc``, as the sweep does."""
    check_supported(cfg)
    rtt_bytes = cfg["rtt_slots"] * cfg["slot_bytes"]
    shared = allocate(np.concatenate([t["size"] for t in tables]),
                      rtt_bytes, cfg["n_prios"]) if shared_alloc else None
    allocs = {i: shared or allocate(tables[i]["size"], rtt_bytes,
                                    cfg["n_prios"]) for i in runs}
    out = {}
    with torch.inference_mode():
        # one batch per static shape (table length, scheduled levels)
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


def _run_block(cfg, tables, allocs, stream, chunk, device, early):
    Ss = [statics(cfg, t, a, device) for t, a in zip(tables, allocs)]
    S = {k: torch.stack([s[k] for s in Ss]) for k in Ss[0]}
    B, M = S["size"].shape
    ns = n_sched(cfg, allocs[0])
    edges_sz = np.asarray(stream["size_edges"], np.int64)
    szb = np.stack([np.searchsorted(edges_sz, t["size"], side="right")
                    for t in tables])
    counted = np.arange(M) >= int(M * stream["warmup_frac"])
    aux = {"szb": torch.from_numpy(szb.astype(np.int64)).to(device),
           "counted": torch.from_numpy(np.broadcast_to(
               counted, (B, M)).copy()).to(device)}
    edges = torch.from_numpy(bucket_edges(stream)).to(device)
    acc = torch.zeros((B, (len(edges_sz) + 1) * stream["n_buckets"]),
                      dtype=I32, device=device)
    st = init_state(cfg, M, B, device)
    ms = cfg["max_slots"]
    stride = chunk if chunk and chunk < ms else ms
    now = torch.zeros((), dtype=I32, device=device)
    for lo in range(0, ms, stride):
        hi = min(lo + stride, ms)
        for _ in range(lo, hi):
            st = step(cfg, S, ns, allocs[0], st, now, early)
            now = now + 1
        acc = _fold(stream, edges, acc, st, S, aux, lo, hi)
    return summary(cfg, st, acc)
