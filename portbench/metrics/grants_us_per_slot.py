"""``grants_us_per_slot`` (layer: grant path; source: device_trace;
moves ``sweep_rate``): the device time a slot of the operations
launched inside the port's ``slot.grants`` spans in the traced stretch,
in microseconds: the receivers' grant decisions (the key matrix, the
top-K, the grant and withheld masks) and the delay history. Each
operation is matched with the runtime call that launched it
(:mod:`portbench.stages`); a slot that launched nothing there reads
0.0.

On backend ``fused`` the slot's top-K runs in the fused kernel at slot
start, outside ``slot.grants``, so this metric does not cover it."""
from portbench import stages


def read(rec: dict) -> float | None:
    return stages.stage_us_per_slot(rec, ("slot.grants",))
