"""``prepare_ms_per_run`` (layer: sweep engine; source: device_trace;
moves ``sweep_rate``): the host's ``sim.prepare`` of the grid's tables
in the traced ``run_sweep`` call, over the call's runs, in
milliseconds: the port's ``sweep.prepare`` span inside the
``sweep.call`` that holds the traced stretch. Every call pays it before
its first slot, with the card idle; it is the largest part of
``host_only_ms_per_run``. It reads a host-clock span taken in the
traced run (:mod:`portbench.stages`)."""
from portbench import stages


def read(rec: dict) -> float | None:
    got = stages.traced_call(rec)
    if got is None:
        return None
    prep = [s for s in got[1] if s[1] == "sweep.prepare"]
    if len(prep) != 1:
        return None
    return (prep[0][3] - prep[0][2]) / 1e6 / rec["cell"]["B"]
