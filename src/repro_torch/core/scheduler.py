"""Batch selection on the host (paper §III-B), PyTorch port.

Counterpart of :func:`repro.core.scheduler.extract_window`, the serial
form of the take rule that the serving control plane runs over its
:class:`~repro_torch.core.queue.HostEventQueue`.  The host schedulers
(``ConservativeScheduler``, ``run_unbatched``, ``SpeculativeScheduler``)
are not ported yet.
"""

from __future__ import annotations

from repro_torch.core.events import Event, EventRegistry
from repro_torch.core.queue import HostEventQueue


def extract_window(
    queue: HostEventQueue,
    registry: EventRegistry,
    max_len: int,
    t_cap: float = float("inf"),
) -> list[Event]:
    """Pop the maximal runnable prefix under the dynamic lookahead window.

    Events are taken in (time, seq) order while the head's timestamp does
    not exceed ``t_max = min(t_cap, min over taken e of t_e + l_e)`` and
    the batch is shorter than ``max_len``.
    """
    batch: list[Event] = []
    t_max = t_cap
    while queue and len(batch) < max_len:
        head = queue.peek()
        if head.time > t_max:
            break
        batch.append(queue.pop())
        la = registry[head.type_id].lookahead
        t_max = min(t_max, head.time + la)
    return batch
