"""``host_us_per_slot`` (layer: slot loop; source: device_trace; moves
``sweep_rate``): the host's own time a slot in the traced stretch, in
microseconds: the port's ``slot`` spans summed, less the window's
``Command Buffer Full`` records inside them, the time a launch spends
blocked on the card's full queue. The launch calls' own time stays in:
it is part of the host's pace. So it is the pace the host could keep;
where it lies below ``device_us_per_slot`` the card sets the pace. It
reads host-clock spans taken in the traced run (:mod:`portbench.stages`).
"""
from portbench import stages

BLOCKED = "Command Buffer Full"


def read(rec: dict) -> float | None:
    spans = stages.stretch(rec)
    if spans is None:
        return None
    slots = [(s[2], s[3]) for s in spans if s[1] == "slot"]
    busy = sum(b - a for a, b in slots)
    blocked = stages.overlap_ns(
        slots, [(a, b) for name, a, b in rec["host"] if name == BLOCKED])
    return (busy - blocked) / 1e3 / rec["slots"]
