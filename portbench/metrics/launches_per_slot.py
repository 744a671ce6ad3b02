"""``launches_per_slot`` (layer: slot loop; moves ``sweep_rate``): kernel
launches in the traced stretch over its slots. The stretch is whole
slots of one batch, so the count is exact and the same at every batch
size of one protocol; a change that merges or removes launches of the
slot loop moves it."""


def read(rec: dict) -> float | None:
    n = sum(1 for _, kind, _, _ in rec["device"] if kind == "kernel")
    return n / rec["slots"] if n else None
