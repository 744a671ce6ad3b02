"""``faults_us_per_slot`` (layer: fault layer; source: device_trace;
moves ``sweep_rate``): the device time a slot of the operations
launched inside the port's ``slot.faults`` spans in the traced stretch,
in microseconds: the loss draws' decisions at the three loss points,
the Gilbert-Elliott step, the drop counters and the flowlet uplink
choice (:mod:`portbench.stages`). A slot that launched nothing there,
as in a fault-free cell, reads 0.0; a program that declares no such
span reads nothing."""
from portbench import stages

SPAN = "slot.faults"


def read(rec: dict) -> float | None:
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    if SPAN not in getattr(spans, "SLOT_SPANS", ()):
        return None
    return stages.stage_us_per_slot(rec, (SPAN,))
