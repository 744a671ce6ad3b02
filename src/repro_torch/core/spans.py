"""Spans: named stretches of the port's own host time, on the clock of
the profiler's records.

A span is ``(name, start_ns, end_ns, parent)``; ``parent`` is the index
of the span that was open when it began (``None`` at the top), and a
span's index is the number of spans begun before it. Spans go into one
buffer of fixed capacity (:class:`Recorder`; the process's is
``RECORDER``). Past the capacity the oldest fall off and ``evicted``
counts them, so a reader can tell that a stretch was lost.

Two tiers:

* call spans (:func:`span`) are always recorded: ``sweep.call`` around
  a ``run_sweep`` call with ``sweep.prepare``, ``sweep.step`` (a chunk)
  and ``sweep.to_host`` inside it, ``faults.plan`` around each block's
  fault plan in ``run_slots`` (fault layer on only), and
  ``simulate.prepare``, ``simulate.load`` and ``simulate.run`` of
  ``simulate``, a few a call;
* slot spans (:func:`slot`) are recorded only inside
  :meth:`Recorder.slot_tier` while ``torch.profiler`` is enabled:
  ``run_slots`` opens the tier and asks the profiler once; elsewhere
  :func:`slot` returns one shared no-op context. They are
  :data:`SLOT_SPANS`: ``slot`` (one ``step_fn`` call) and its stages
  ``slot.grants``, ``slot.uplink``, ``slot.drain`` and ``slot.stats``,
  ``ring.insert`` inside every ``fabric.ring_insert``, and, where the
  fault layer is on, ``slot.faults`` (its loss points, the
  Gilbert–Elliott step and the non-ECMP uplink choice; inside
  ``slot.uplink`` for the forwarding losses) and ``slot.recovery``.

Each span is read: ``simulate.*`` by ``TraceConfig(wallclock=True)``'s
timings, the rest by the benchmark's per-layer metrics.

Times come from :data:`now`, the clock that kineto stamps its host and
device records with (``CLOCK_REALTIME``), so a span compares directly
with a profiler window's records. Recording a span touches no tensor:
it launches nothing, never synchronizes and reads nothing back from a
device.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque

import torch

CAPACITY = 65536
now = time.time_ns                  # the profiler's clock, in ns
# the slot spans this program can record; a reader finds here whether a
# span it reads exists in the program it runs against
SLOT_SPANS = ("slot", "slot.grants", "slot.uplink", "slot.drain",
              "slot.stats", "ring.insert", "slot.faults", "slot.recovery")


class Span:
    """One span; a context manager that records itself on entry."""
    __slots__ = ("rec", "name", "index", "parent", "start_ns", "end_ns")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name, self.end_ns = rec, name, None

    def __enter__(self) -> "Span":
        rec = self.rec
        self.parent = rec.open[-1] if rec.open else None
        self.index = rec.started
        rec.started += 1
        rec.buf.append(self)
        rec.open.append(self.index)
        self.start_ns = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = now()
        self.rec.open.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """A buffer of the last ``capacity`` spans begun, the indices of the
    spans open now, and whether slot spans are being recorded."""

    def __init__(self, capacity: int = CAPACITY):
        self.buf: deque[Span] = deque(maxlen=capacity)
        self.open: list[int] = []
        self.started = 0
        self.slots = False

    @property
    def evicted(self) -> int:
        """Spans that fell off the buffer."""
        return self.started - len(self.buf)

    def records(self) -> list[tuple]:
        """The closed spans in the buffer, oldest first, as ``(index,
        name, start_ns, end_ns, parent)``."""
        return [(s.index, s.name, s.start_ns, s.end_ns, s.parent)
                for s in list(self.buf) if s.end_ns is not None]

    @contextlib.contextmanager
    def slot_tier(self):
        """Record slot spans inside this block if the profiler is
        enabled as it opens."""
        was = self.slots
        self.slots = torch._C._autograd._profiler_enabled()
        try:
            yield
        finally:
            self.slots = was


RECORDER = Recorder()
NOOP = contextlib.nullcontext()


def span(name: str) -> Span:
    """A call span of the process's recorder."""
    return Span(RECORDER, name)


def slot(name: str):
    """A slot span of the process's recorder, or :data:`NOOP` outside a
    profiled slot tier."""
    rec = RECORDER
    return Span(rec, name) if rec.slots else NOOP


__all__ = ["CAPACITY", "SLOT_SPANS", "RECORDER", "NOOP", "Recorder", "Span",
           "now", "span", "slot"]
