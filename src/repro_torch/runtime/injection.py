"""Deterministic fault-injection schedule (PyTorch port).

The port's copy of :mod:`repro.runtime.injection`, used by its engine
fault-injection harness (:mod:`repro_torch.testing.faults`): a sorted
list of ``(step, kind)`` events polled against a monotone step counter,
each event firing exactly once.

The ``kind`` vocabulary is the consumer's: the engine harness uses its
fault class names (``nan_time``, ``dup_seq``, ...) and ``crash``.  The
injector itself is policy-free: it only answers "does an event fire at
or before this step".
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str
    node: int = 0
    detail: str = ""


class FailureInjector:
    """Deterministic schedule of simulated failures.

    ``poll(step)`` fires (at most) the earliest scheduled event whose
    step is ``<= step``, exactly once; fired events accumulate in
    ``self.fired`` for assertions.
    """

    def __init__(self, events: list[FailureEvent]):
        self.events = sorted(events, key=lambda e: e.step)
        self.fired: list[FailureEvent] = []

    def poll(self, step: int) -> Optional[FailureEvent]:
        if self.events and self.events[0].step <= step:
            ev = self.events.pop(0)
            self.fired.append(ev)
            return ev
        return None
