"""``device_idle`` (layer: device; moves ``sweep_rate``): the share of
the traced stretch in which no operation ran on the card, in percent:
one less the union of the device operations' intervals over the
stretch's span. High where the host sets the pace."""
from portbench.profiling import busy_ns


def read(rec: dict) -> float | None:
    lo, hi = rec["span"]
    busy = busy_ns(rec)
    return 100.0 * (1.0 - busy / (hi - lo)) if busy else None
