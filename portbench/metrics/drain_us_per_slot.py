"""``drain_us_per_slot`` (layer: drains; source: device_trace; moves
``sweep_rate``): the device time a slot of the operations launched
inside the port's ``slot.uplink`` and ``slot.drain`` spans in the
traced stretch and outside ``ring.insert``, in microseconds: both
tiers' eligibility, the ``priority_arbiter`` launches and the drained
chunks' bookkeeping (:mod:`portbench.stages`).

On backend ``fused`` both arbitrations run in the fused kernel at slot
start, outside these spans, so this metric does not cover them."""
from portbench import stages


def read(rec: dict) -> float | None:
    return stages.stage_us_per_slot(rec, ("slot.uplink", "slot.drain"))
