"""``insert_us_per_slot`` (layer: ring insert; source: device_trace;
moves ``sweep_rate``): the device time a slot of the operations
launched inside the port's ``ring.insert`` spans in the traced stretch,
in microseconds: every ``fabric.ring_insert`` of both tiers (the free
slots' ``cumsum``, the search and the drop scatters' copies), wherever
it is called from (:mod:`portbench.stages`)."""
from portbench import stages


def read(rec: dict) -> float | None:
    return stages.stage_us_per_slot(rec, ("ring.insert",))
