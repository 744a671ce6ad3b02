"""``recovery_us_per_slot`` (layer: loss recovery; source: device_trace;
moves ``sweep_rate``): the device time a slot of the operations
launched inside the port's ``slot.recovery`` spans in the traced
stretch, in microseconds: the end-of-slot RESEND and sender-fallback
timers over (runs, messages), the rewinds and their counters
(:mod:`portbench.stages`). A slot that launched nothing there, as in a
fault-free cell, reads 0.0; a program that declares no such span reads
nothing."""
from portbench import stages

SPAN = "slot.recovery"


def read(rec: dict) -> float | None:
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    if SPAN not in getattr(spans, "SLOT_SPANS", ()):
        return None
    return stages.stage_us_per_slot(rec, (SPAN,))
