"""``host_only_ms_per_run`` (layer: sweep engine; source: device_trace;
moves ``sweep_rate``): the part of the traced ``run_sweep`` call in
which the card has no slot queued, over the call's runs, in
milliseconds: the port's ``sweep.call`` span whose ``sweep.step`` holds
the traced stretch, less the time from its first ``sweep.step`` start
to its last ``sweep.to_host`` end. That is the host's resolve, priority
allocation, ``prepare`` and batching before the first slot, and the
rows after the last copy to the host. It reads host-clock spans taken
in the traced run (:mod:`portbench.stages`)."""
from portbench import stages


def read(rec: dict) -> float | None:
    got = stages.traced_call(rec)
    if got is None:
        return None
    call, kids = got
    first = min(s[2] for s in kids if s[1] == "sweep.step")
    to_host = [s[3] for s in kids if s[1] == "sweep.to_host"]
    if not to_host:
        return None
    device = max(to_host) - first
    return (call[3] - call[2] - device) / 1e6 / rec["cell"]["B"]
