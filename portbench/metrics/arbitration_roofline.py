"""``arbitration_roofline`` (layer: arbitration kernels; moves
``sweep_rate``): the least time the slots' arbitration could take on
the card's HBM, over the device time of every launch of the
arbitration kernels (``priority_arbiter*``, ``srpt_topk*``,
``fused_slot*``) in the traced stretch, in percent.

The bytes follow the work and not the kernel or route that does it, so
a fused kernel or another backend leaves the count as it is. Each byte
is read once and written once (the counts of ``chip_smoke.py``'s
``_fused_bytes``): per run and slot, every slot of both drain tiers'
rings is read (prio and seq, 4 bytes each, the eligibility 1 byte) and
each ring's winner written (prio and index, 8 bytes); where the
receivers grant, the (hosts x messages) int32 key matrix is read and
the top-K keys and columns written (8 bytes a rank). A reading above
100% means the count is wrong."""
from portbench.peaks import HBM_BYTES_PER_S

KERNELS = ("priority_arbiter", "srpt_topk", "fused_slot")


def slot_bytes(B: int, H: int, cap: int, U: int, ucap: int, M: int,
               K: int) -> int:
    """Least HBM bytes of one slot's arbitration of B runs: downlink
    rings (H x cap), uplink rings (U x ucap; 0 on a single switch) and,
    with K > 0, the grant top-K over (H x M) keys."""
    rings = 9 * (H * cap + U * ucap) + 8 * (H + U)
    grants = 4 * H * M + 8 * H * K if K else 0
    return B * (rings + grants)


def read(rec: dict) -> float | None:
    ns = sum(b - a for name, kind, a, b in rec["device"]
             if kind == "kernel" and any(k in name for k in KERNELS))
    if not ns:
        return None
    bound_s = rec["slots"] * slot_bytes(**rec["cell"]) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (ns / 1e9)
