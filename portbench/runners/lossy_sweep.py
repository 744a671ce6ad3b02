"""The runner of the sweep cells whose fabric has a fault layer: the
sweep runner (``runners/sweep.py``: its program, checked runs, window,
traced stretch and result, unchanged) with more integers compared.

Where the configuration's fabric has faults, each checked run's
``SweepStats`` also gives the chunks the faults dropped
(``fault_lost_chunks``), the chunks retransmitted (``retx_chunks``) and
its rewinds fired by a receiver's RESEND and by the sender fallback
(``resend_rewinds``, ``timeout_rewinds``); each must equal the
reference's (``f_lost``, ``retx``, ``rw_resend``, ``rw_timeout``)
exactly, in every call of the window, beside every integer the sweep
runner compares (``mismatched_ints``, limit 0).

Each run says on standard error the fault counters of the runs the
reference checks (least, most and sum of each). A program whose
``SweepStats`` has no rewind counts cannot be checked so: the run exits
at once with a message and no result.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

from portbench import harness

# a copy of the sweep runner of its own, whose ``judge`` compares this
# file's integers; the sweep cells load theirs afresh
base = harness.load_module("runners", "sweep",
                           Path(__file__).resolve().parents[1])
program, check_runs, mismatches = base.program, base.check_runs, \
    base.mismatches
sweep_ints = base.as_ints
FAULT_INTS = {"f_lost": "fault_lost_chunks", "retx": "retx_chunks",
              "rw_resend": "resend_rewinds", "rw_timeout": "timeout_rewinds"}


def as_ints(s, config: dict, reference) -> dict:
    """The sweep runner's integers of a ``SweepStats``, and the fault
    layer's where the fabric has one."""
    out = sweep_ints(s, config, reference)
    if (config.get("fabric") or {}).get("faults") is not None:
        out.update({k: getattr(s, f) for k, f in FAULT_INTS.items()})
    return out


base.as_ints = as_ints


class Reported:
    """The plan's reference, saying on an earlier line the fault counters
    of the runs it checks."""

    def __init__(self, ref):
        self.ref = ref

    def __getattr__(self, name):
        return getattr(self.ref, name)

    def run(self, *args, **kw):
        rows = self.ref.run(*args, **kw)
        if rows and "f_lost" in rows[0]:
            base.say(f"fault counters of the {len(rows)} checked runs: "
                     + "; ".join(f"{k} {min(int(r[k]) for r in rows)}.."
                                 f"{max(int(r[k]) for r in rows)}, sum "
                                 f"{sum(int(r[k]) for r in rows)}"
                                 for k in FAULT_INTS))
        return rows


def run(plan, **kw) -> dict:
    from repro_torch.core import sweep
    fields = {f.name for f in dataclasses.fields(sweep.SweepStats)}
    missing = sorted(set(FAULT_INTS.values()) - fields)
    if missing:
        sys.exit(f"portbench: the program's SweepStats has no {missing}; "
                 f"the {plan.cell['name']} cell compares them")
    return base.run(dataclasses.replace(plan,
                                        reference=Reported(plan.reference)),
                    **kw)
