"""``stats_us_per_slot`` (layer: slot statistics; source: device_trace;
moves ``sweep_rate``): the device time a slot of the operations
launched inside the port's ``slot.stats`` spans in the traced stretch,
in microseconds: the queue statistics and the ``wasted`` mask over
(runs, hosts, messages) (:mod:`portbench.stages`)."""
from portbench import stages


def read(rec: dict) -> float | None:
    return stages.stage_us_per_slot(rec, ("slot.stats",))
