"""``device_us_per_slot`` (layer: device; moves ``sweep_rate``): the
summed device time of every operation in the traced stretch over its
slots, in microseconds: the time a slot would take once the host no
longer sets the pace."""


def read(rec: dict) -> float | None:
    ns = sum(b - a for _, _, a, b in rec["device"])
    return ns / 1e3 / rec["slots"] if ns else None
