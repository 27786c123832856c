"""Batch selection and execution on the host (paper §III-B), PyTorch
port.

Counterpart of :mod:`repro.core.scheduler`.  Extraction rule (paper
Fig 2): iterate over the future events in time order, maintaining the
dynamic lookahead window ``t_max = min over extracted e of (t_e +
l_e)``; an event is extracted while its timestamp does not exceed the
current ``t_max`` and the batch is shorter than the maximum length.
The extracted word is encoded with the codec and its composed program
runs.

Schedulers:

* :class:`ConservativeScheduler` — the paper's runtime mechanism.
* :func:`run_unbatched` — one event at a time, the sequential baseline.
* :class:`SpeculativeScheduler` — the paper's §IV.D future-work
  variant: extract past the lookahead window, keep a snapshot of the
  state, and roll back if an emitted event lands inside the executed
  window.

Emission anchoring: handlers emit ``(delay, type, arg)`` and the new
event is scheduled at ``t_emitter + delay``, a Python float computed on
the host from the heap's f64 time, identically on the three paths.
Emissions whose type is negative are ν-rows and are skipped everywhere,
the speculative violation predicate included.  ``t_end``: a batch (or
event) starts only while the earliest pending event's time is at most
``t_end``.

How the JAX runtime maps onto PyTorch:

* A batch's times and arguments reach the device in one copy
  (:func:`repro_torch.core.composer.batch_inputs`), and its emissions
  come back in one counted read (``COUNTS["host_syncs"]``): the
  emitted tensors are concatenated and read together, where JAX's
  ``int(type_id)`` and ``float(delay)`` each transfer.  A batch whose
  handlers emit nothing, or emit Python numbers, reads nothing.
* JAX arrays are immutable, so JAX's speculative snapshot is a
  reference.  Port handlers may update state tensors in place, so the
  speculative scheduler clones the state tree before each batch, and
  every scheduler runs on its own copy of the initial state, as the
  device engine does.
* ``jit_handlers`` (JAX: the unbatched baseline's ``jax.jit`` switch;
  the JAX composers always compile) picks the compile route for all
  three schedulers here, through the composer's ``jit_handlers`` and
  :func:`run_unbatched`'s own.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.core.composer import (
    _ComposerBase,
    batch_inputs,
    compile_fn,
    named_function,
)
from repro_torch.core.events import Event, EventRegistry
from repro_torch.core.queue import (
    COUNTS,
    HostEventQueue,
    window_prefix_mask,
)
from repro_torch.core.tree import tree_map


@dataclasses.dataclass
class RunStats:
    events_executed: int = 0
    batches_executed: int = 0
    rollbacks: int = 0
    final_time: float = 0.0
    batch_length_hist: dict[int, int] = dataclasses.field(default_factory=dict)

    def record_batch(self, length: int) -> None:
        self.batches_executed += 1
        self.events_executed += length
        self.batch_length_hist[length] = self.batch_length_hist.get(length, 0) + 1

    @property
    def mean_batch_length(self) -> float:
        if not self.batches_executed:
            return 0.0
        return self.events_executed / self.batches_executed


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


def extract_window_presorted(
    events: list[Event],
    registry: EventRegistry,
    max_len: int,
) -> int:
    """Length of the runnable prefix of an already-(time, seq)-sorted
    list, by the vectorized take rule the device queue uses
    (:func:`repro_torch.core.queue.window_prefix_mask`) over f32 times
    and bounds, on the CPU."""
    if not events:
        return 0
    cand = events[:max_len]
    ts = torch.from_numpy(np.asarray([ev.time for ev in cand], np.float32))
    wins = torch.from_numpy(np.asarray(
        [ev.time + registry[ev.type_id].lookahead for ev in cand],
        np.float32))
    valid = torch.ones((len(cand),), dtype=torch.bool)
    return int(window_prefix_mask(ts, wins, valid).sum())


def _own_copy(state, device):
    """The state tree's tensors copied onto ``device`` (other leaves,
    Python numbers of a raw registry, as they are)."""
    return tree_map(
        lambda x: x.to(device, copy=True) if torch.is_tensor(x) else x,
        state)


def _snapshot(state):
    return tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, state)


def host_emissions(emitted: list) -> list:
    """``emitted`` with every tensor field read to the host, in one
    counted read for the whole batch: a 0-d tensor becomes a numpy
    scalar, any other a numpy array.  Nothing is read when no field is
    a tensor."""
    parts = [v.reshape(-1) for row in emitted for v in row
             if torch.is_tensor(v)]
    if not parts:
        return emitted
    if len({p.dtype for p in parts}) > 1:
        parts = [p.to(torch.float64) for p in parts]
    COUNTS["host_syncs"] += 1
    flat = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for row in emitted:
        vals = []
        for v in row:
            if torch.is_tensor(v):
                n = v.numel()
                vals.append(flat[at] if v.dim() == 0
                            else flat[at:at + n].reshape(tuple(v.shape)))
                at += n
            else:
                vals.append(v)
        out.append(tuple(vals))
    return out


class ConservativeScheduler:
    """Paper §III-B: lookahead-window batches over a host event queue."""

    def __init__(self, registry: EventRegistry, composer: _ComposerBase,
                 *, check_causality: bool = False):
        self.registry = registry
        self.composer = composer
        self.max_len = composer.codec.max_len
        self.check_causality = check_causality

    @classmethod
    def from_program(cls, program, *, composer: _ComposerBase | None = None,
                     check_causality: bool = False, **composer_kw):
        """Construct from a frozen SimProgram (host-adapted registry);
        ``composer_kw`` (``device``, ``jit_handlers``) builds the
        default lazy composer."""
        from repro_torch.core.composer import LazyComposer

        composer = composer or LazyComposer.from_program(program,
                                                         **composer_kw)
        return cls(program.host_registry(), composer,
                   check_causality=check_causality)

    def run(self, state, queue: HostEventQueue, *,
            max_events: int | None = None,
            max_batches: int | None = None,
            t_end: float = float("inf")) -> tuple[Any, RunStats]:
        stats = RunStats()
        device = self.composer.device
        state = _own_copy(state, device)
        budget = float("inf") if max_events is None else max_events
        b_budget = float("inf") if max_batches is None else max_batches
        while (queue and stats.events_executed < budget
               and stats.batches_executed < b_budget
               and queue.peek().time <= t_end):
            batch = extract_window(queue, self.registry, self.max_len,
                                   t_cap=t_end)
            if not batch:  # cannot happen: first event is always extractable
                break
            code = self.composer.codec.encode([ev.type_id for ev in batch])
            ts, args = batch_inputs([ev.time for ev in batch],
                                    [ev.arg for ev in batch], device)
            state, emitted = self.composer.execute(code, state, ts, args)
            # Deferred scheduling (§IV.D): the batch's emissions are
            # inserted only now, anchored at the EMITTING event's time.
            last_t = batch[-1].time
            for (src, delay, type_id, arg) in host_emissions(emitted):
                ty = int(type_id)
                if ty < 0:
                    continue  # ν-row (unused fixed-record slot)
                t_new = float(batch[src].time) + float(delay)
                if self.check_causality and t_new < last_t:
                    raise RuntimeError(
                        f"causality violation: event type {ty} emitted "
                        f"at {t_new} < batch end {last_t}; lookahead too "
                        "large for this model"
                    )
                queue.push(t_new, ty, arg)
            stats.record_batch(len(batch))
            stats.final_time = last_t
        return state, stats


# Compiled handlers of the unbatched baseline, by handler: repeated runs
# of one registry reuse them instead of compiling again.
_COMPILED_HANDLERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _compiled_handler(et):
    try:
        return _COMPILED_HANDLERS[et.handler]
    except (KeyError, TypeError):
        pass
    handler = et.handler

    def call(state, t, arg):
        return handler(state, t, arg)

    name = f"handler_{et.name}"
    prog = compile_fn(named_function(call, name), name)
    try:
        _COMPILED_HANDLERS[et.handler] = prog
    except TypeError:  # not weakly referenceable: compiled per run
        pass
    return prog


def _run_one(handler, returns_events, state, ev, device, queue):
    """Execute one event eagerly or through ``handler`` and push its
    emissions, anchored at the event's time."""
    ts, args = batch_inputs([ev.time], [ev.arg], device)
    result = handler(state, ts[0], args[0])
    if not returns_events:
        return result
    state, emitted = result
    for (delay, type_id, arg) in host_emissions(list(emitted)):
        ty = int(type_id)
        if ty < 0:
            continue  # ν-row (unused fixed-record slot)
        queue.push(ev.time + float(delay), ty, arg)
    return state


def run_unbatched(
    registry: EventRegistry,
    state,
    queue: HostEventQueue,
    *,
    jit_handlers: bool = True,
    max_events: int | None = None,
    max_batches: int | None = None,
    t_end: float = float("inf"),
    device=None,
) -> tuple[Any, RunStats]:
    """One-by-one execution, the common sequential DES baseline.

    With ``jit_handlers`` each handler is compiled on its own (what a
    PyTorch DES without cross-event batching would do), so the
    comparison against batched execution isolates the *cross-event*
    optimization.  ``device=None`` is the CUDA card.
    """
    from repro_torch.core.engine import resolve_device

    device = resolve_device(device)
    stats = RunStats()
    progs = {et.type_id: _compiled_handler(et) if jit_handlers
             else et.handler for et in registry}
    state = _own_copy(state, device)
    budget = float("inf") if max_events is None else max_events
    if max_batches is not None:  # one event per "batch" here
        budget = min(budget, max_batches)
    while (queue and stats.events_executed < budget
           and queue.peek().time <= t_end):
        ev = queue.pop()
        state = _run_one(progs[ev.type_id],
                         registry[ev.type_id].returns_events, state, ev,
                         device, queue)
        stats.record_batch(1)
        stats.final_time = ev.time
    return state, stats


class SpeculativeScheduler:
    """Optimistic batches with rollback (paper §IV.D future work).

    Events are extracted up to ``max_len`` past the lookahead window
    (by at most ``window_slack``, and never past the run horizon), in
    timestamp order.  The state is snapshotted (cloned) before the
    batch; if the batch emits an event whose time falls before the time
    of the last event executed in the batch, the batch is rolled back
    and replayed one event at a time, each handler called eagerly.
    """

    def __init__(self, registry: EventRegistry, composer: _ComposerBase,
                 *, window_slack: float = float("inf")):
        self.registry = registry
        self.composer = composer
        self.max_len = composer.codec.max_len
        # How far past t_max we are willing to speculate.
        self.window_slack = window_slack

    @classmethod
    def from_program(cls, program, *, composer: _ComposerBase | None = None,
                     window_slack: float = float("inf"), **composer_kw):
        """Construct from a frozen SimProgram (host-adapted registry)."""
        from repro_torch.core.composer import LazyComposer

        composer = composer or LazyComposer.from_program(program,
                                                         **composer_kw)
        return cls(program.host_registry(), composer,
                   window_slack=window_slack)

    def _extract_speculative(self, queue: HostEventQueue,
                             t_cap: float = float("inf")):
        batch: list[Event] = []
        t_max = float("inf")
        while queue and len(batch) < self.max_len:
            head = queue.peek()
            # Speculation may run past the lookahead window (by
            # window_slack) but never past the run horizon t_cap.
            if head.time > min(t_max + self.window_slack, t_cap):
                break
            batch.append(queue.pop())
            la = self.registry[head.type_id].lookahead
            t_max = min(t_max, head.time + la)
        return batch, t_max

    def run(self, state, queue: HostEventQueue, *,
            max_events: int | None = None,
            max_batches: int | None = None,
            t_end: float = float("inf")) -> tuple[Any, RunStats]:
        stats = RunStats()
        device = self.composer.device
        state = _own_copy(state, device)
        budget = float("inf") if max_events is None else max_events
        b_budget = float("inf") if max_batches is None else max_batches
        while (queue and stats.events_executed < budget
               and stats.batches_executed < b_budget
               and queue.peek().time <= t_end):
            batch, _t_max = self._extract_speculative(queue, t_cap=t_end)
            code = self.composer.codec.encode([ev.type_id for ev in batch])
            ts, args = batch_inputs([ev.time for ev in batch],
                                    [ev.arg for ev in batch], device)
            snapshot = _snapshot(state)
            state_new, emitted = self.composer.execute(code, state, ts, args)
            emitted = host_emissions(emitted)
            last_t = batch[-1].time
            # Causality check, per emission: the new event lands at
            # t_emitter + delay; if any event with a LATER time already
            # executed in this batch, that event ran without seeing the
            # emission and the batch must roll back.  Ties are safe:
            # the emission gets a later seq.
            violated = any(
                int(_ty) >= 0
                and float(batch[src].time) + float(delay) < last_t
                for (src, delay, _ty, _a) in emitted
            )
            if violated:
                # Rollback: restore the snapshot, requeue, replay one
                # by one.
                stats.rollbacks += 1
                state = snapshot
                for ev in batch:
                    queue.push_event(ev)
                for _ in range(len(batch)):
                    ev = queue.pop()
                    et = self.registry[ev.type_id]
                    state = _run_one(et.handler, et.returns_events, state,
                                     ev, device, queue)
                    stats.record_batch(1)
                    stats.final_time = ev.time
                continue
            state = state_new
            for (src, delay, type_id, arg) in emitted:
                if int(type_id) < 0:
                    continue  # ν-row
                queue.push(
                    float(batch[src].time) + float(delay), int(type_id), arg
                )
            stats.record_batch(len(batch))
            stats.final_time = last_t
        return state, stats
