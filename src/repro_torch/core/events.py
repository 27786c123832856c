"""Event types, lookahead, and the event record format (PyTorch port).

Counterpart of :mod:`repro.core.events`.  `EventRegistry` is the paper's
constant array of event handlers (§III-A): an ordered,
immutable-after-freeze list of event types, each pairing a handler with
a per-type *lookahead* (the minimum delta between an event's execution
time and the earliest timestamp of any event it may create, §III-B).

Handlers work on torch tensors:

    handler(state, t: f32 0-d tensor, arg: f32[ARG_WIDTH]) -> state
        or -> (state, new_events)

On-device events are fixed records ``(time: f32, type: i32,
arg: f32[ARG_WIDTH])``; rich payloads live in the state tree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

# Width of the inline argument vector carried by on-device events.
ARG_WIDTH = 4


@dataclasses.dataclass(frozen=True)
class EventType:
    """One character of the event alphabet Σ."""

    type_id: int            # dense index into the registry (0-based)
    name: str
    handler: Callable       # (state, t, arg) -> state | (state, events)
    lookahead: float        # l_e >= 0; inf allowed (never blocks)
    returns_events: bool    # whether handler returns (state, new_events)


@dataclasses.dataclass(frozen=True)
class Event:
    """A host-side scheduled event instance."""

    time: float
    type_id: int
    arg: Any = None
    # Monotonic sequence number used as a tie-breaker so that events with
    # equal timestamps execute in schedule order (deterministic runs).
    seq: int = 0

    def key(self):
        return (self.time, self.seq)


def emits_events(handler: Callable) -> Callable:
    """Decorator marking a handler as returning ``(state, new_events)``.

    Returns a wrapper carrying ``returns_events = True`` rather than
    mutating ``handler``; the wrapped callable stays reachable via
    ``__wrapped__``.
    """

    @functools.wraps(handler)
    def wrapper(*args, **kwargs):
        return handler(*args, **kwargs)

    wrapper.returns_events = True
    return wrapper


class EventRegistry:
    """The ordered array of event handlers (the alphabet Σ).

    Its order defines the digit values of the batch codec, so it must
    not change once frozen.
    """

    def __init__(self):
        self._types: list[EventType] = []
        self._by_name: dict[str, EventType] = {}
        self._frozen = False

    def register(self, name: str, handler: Callable, *,
                 lookahead: float = float("inf")) -> EventType:
        if self._frozen:
            raise RuntimeError(
                "EventRegistry is frozen; register all event types before "
                "composing batches (paper §III-A: constant handler array)."
            )
        if name in self._by_name:
            raise ValueError(f"event type {name!r} already registered")
        if lookahead < 0:
            raise ValueError("lookahead must be >= 0")
        et = EventType(
            type_id=len(self._types),
            name=name,
            handler=handler,
            lookahead=float(lookahead),
            returns_events=bool(getattr(handler, "returns_events", False)),
        )
        self._types.append(et)
        self._by_name[name] = et
        return et

    def freeze(self) -> "EventRegistry":
        self._frozen = True
        return self

    def __len__(self) -> int:
        return len(self._types)

    def __iter__(self):
        return iter(self._types)

    def __getitem__(self, idx) -> EventType:
        if isinstance(idx, str):
            return self._by_name[idx]
        return self._types[idx]

    @property
    def names(self) -> list[str]:
        return [t.name for t in self._types]

    def lookaheads(self, device) -> torch.Tensor:
        """Per-type lookahead vector (f32, inf-safe) on ``device``."""
        return torch.tensor([t.lookahead for t in self._types],
                            dtype=torch.float32, device=device)


def normalize_handler_result(result, *, returns_events: bool):
    """Canonicalize a handler result to ``(state, list_of_new_events)``."""
    if returns_events:
        state, new_events = result
        return state, list(new_events)
    return result, []
