"""The host-runtime facade and the on-device simulation engine
(PyTorch port).

:class:`Simulator` is the counterpart of :class:`repro.core.engine.
Simulator`: a Python event loop over a binary heap dispatching composed
batch programs (the paper's runtime), through the schedulers of
:mod:`repro_torch.core.scheduler`.

:class:`DeviceEngine` is the counterpart of :class:`repro.core.engine.
DeviceEngine`: ``queue_mode``
in ``{"tiered3", "tiered", "flat", "reference"}``, ``dispatch_mode`` in
``{"switch", "masked", "fused"}``, ``validate`` in ``{"off", "cheap",
"full"}`` and ``overflow`` in ``{"drop", "error", "spill"}`` (spill on
tiered3 only, as in JAX), with the entity-parallel run path.  The
sharded engine (:mod:`repro_torch.core.sharded`) subclasses it.

JAX compiles the whole run into one ``lax.while_loop``.  Here, with
``loop="eager"`` (the default, and the spec), the loop is a Python loop
over eager super-steps, each of which:

1. reads the loop guard (pending events, ``next_time <= t_end``) to the
   host;
2. extracts the §III-B window: on the tiered queues the bounded refill,
   then the ``window_extract`` kernel (:func:`tiered3_queue_extract`,
   :func:`tiered_queue_extract`); on the flat queue the same rule over
   its sorted prefix, on the reference queue ``max_batch_len`` serial
   argmin rounds, both as torch operations;
3. reads the window's types and length to the host once and runs, as
   straight-line eager code, the vmapped run handler when the window
   is a run of one entity-parallel type, else the composed branch
   (``switch``), the per-lane legs (``masked``) or the hot word's
   branch or the masked fallback (``fused``, chosen by the host-side
   word code);
4. inserts the emitted rows: on the tiered queues the pre-flush check,
   then the ``front_merge`` kernel; on the flat queue a counting-merge,
   on the reference queue a first-free-slot scatter.

So a common super-step costs four device-to-host reads on the tiered
queues (the guard, the refill check, the window, the pre-flush check)
and two on the flat and reference queues (the guard and the window),
counted with the queue's rare-path reads in
``repro_torch.core.queue.COUNTS``, which also counts the windows that
took the run path (``run_path``), a hot slot (``fused_hot``) and the
fallback (``fused_fallback``), and, as ``loop_syncs``, the reads made
inside ``run``'s loop (a segmented run's boundaries read more).  The
stats carry (``batches``, ``events``, ``emitted``, ``time``,
``word_counts``, and ``fault_word`` / the spill buffer and fence when
``validate`` / ``overflow="spill"`` enable them) matches the JAX
engine's field for field; ``batches`` and ``events`` are host ints.

``loop="captured"`` is the counterpart of JAX's jitted loop itself
(:meth:`DeviceEngine._super_steps_captured`): one super-step, every
branch of it selected on the device (the queue's rare paths as
:func:`repro_torch.core.capture.cond`, the dispatch and the run path as
:func:`~repro_torch.core.capture.select`), the whole body under
``when(active)`` with the guard (``_guard``'s terms and ``batches <
max_batches``) recomputed at its end.  On a CUDA device that step is
captured once as a CUDA graph with conditional nodes and replayed
``chunk`` times between host reads, each read carrying ``(active,
batches, events)`` and the capture's counters (the rare paths',
``run_path``'s, the fused routes' and each body's executions, which
become ``COUNTS`` and the kernels' ``LAUNCHES``).  ``chunk`` defaults to
64: on an H100 (700 W), PHOLD at 917,504 LPs replayed 1,958, 1,978 and
1,986 steps/s at chunks of 32, 64 and 128, and 1,533, 1,492 and 1,690
beside a slower host (``chip_smoke.py`` phase ``captured`` (a)): no
chunk size wins beyond the noise, and a larger chunk only adds no-op
replays after the guard stops.  The graph is kept across runs and
segments of one signature (carry shapes and ``t_end``, which the
``window_extract`` launch takes by value).  On the CPU the same step
runs eagerly with its predicates read on the host
(``COUNTS["cond_reads"]``), and ``captures`` counts the graphs a card
would capture.  It takes every configuration of this engine: the four
queue modes (the two-tier queue's flush and refill as conditional
nodes; the flat and reference queues have no branch), every dispatch
mode, ``validate``, and ``overflow`` in ``{"drop", "error", "spill"}``.
A fenced run (spill, or a streamed run) carries the fence and the spill
buffer in the step's stats: the guard stops at the fence or at the
first spill, and the segment loop's boundary work (absorbs, rebalances,
the new fence, the buffer's drain) stays eager, between runs that
replay the run's one graph (the boundary writes its results into the
graph's carry).  The sharded engine (:mod:`repro_torch.core.sharded`)
supplies its own step, guard and carry through the same loop
(:meth:`DeviceEngine._carry_queue`, :meth:`_active`, :meth:`_step_body`)
under both placements; its one refusal is ``placement="devices"`` on a
CUDA device over a group that is not NCCL's.

The robustness modes add no read to a common super-step: every check
they make is folded into the one guard read.

* ``validate != "off"``: the cheap fault bits of the queue mode
  (:mod:`repro_torch.core.validate`) are ORed into ``fault_word`` on the
  device each super-step, and the guard stops on a set bit.  ``"full"``
  adds the O(capacity) audit when ``run`` returns (a segment boundary).
* ``overflow="error"``: the guard stops on ``dropped > 0`` and ``run``
  raises ``FAULT_OVERFLOW``.
* ``overflow="spill"``: emits that do not fit go to a device buffer in
  the stats carry (``spill_rows``, ``spill_seqs``, ``spill_n``) instead
  of being dropped, the lex fence (``bound_t``, ``bound_seq``) tightens
  to the earliest spilled key, and the guard stops on ``spill_n > 0``
  so the caller (``CompiledSim.run``'s segment loop) drains the buffer.
* A fenced run (spill, or a streamed run whose stats carry
  ``bound_t``/``bound_seq``) passes the fence to the extract's
  ``window_extract`` launch, and the guard stops when the next pending
  key reaches it.  Only the tiered3 queue has the fence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.capture import (
    EmulateContext,
    bump,
    capture_graph,
    cond,
    launch_totals,
    select,
    set_launches,
    signature,
    step_context,
    write_back,
)
from repro_torch.core.codec import DenseCodec, make_codec
from repro_torch.core.composer import (
    EagerComposer,
    LazyComposer,
    build_fused_dispatcher,
    build_masked_dispatcher,
    build_switch_dispatcher,
)
from repro_torch.core import validate as _validate
from repro_torch.core.events import ARG_WIDTH, EventRegistry
from repro_torch.core.queue import (
    COUNTS,
    I32_MAX,
    INF,
    HostEventQueue,
    _f32,
    _prefix_rank,
    _scatter_rows,
    device_queue_extract,
    device_queue_extract_ref,
    device_queue_fill_rows,
    device_queue_from_host,
    device_queue_next_time,
    device_queue_next_time_ref,
    device_queue_occupancy,
    device_queue_push_rows,
    host_list,
    host_read,
    i32_sat,
    tiered3_queue_absorb_rows,
    tiered3_queue_extract,
    tiered3_queue_fill_rows,
    tiered3_queue_fill_rows_tagged,
    tiered3_queue_from_columns,
    tiered3_queue_from_host,
    tiered3_queue_has_pending,
    tiered3_queue_next_key,
    tiered3_queue_next_time,
    tiered3_queue_occupancy,
    tiered_queue_extract,
    tiered_queue_fill_rows,
    tiered_queue_from_host,
    tiered_queue_has_pending,
    tiered_queue_next_time,
    tiered_queue_occupancy,
    to_local,
)
from repro_torch.core.scheduler import (
    ConservativeScheduler,
    RunStats,
    SpeculativeScheduler,
    run_unbatched,
)
from repro_torch.core.tree import tree_map
from repro_torch.core.validate import (
    FAULT_CLOCK,
    FAULT_OVERFLOW,
    EngineFaultError,
)
from repro_torch.core.vectorize import make_masked_run_handler

# The fused mode's hot-set width when no hot_words are given (the first
# W dense codes), and the word count beyond which the per-word
# histogram is not carried (the JAX engine's values).
_DEFAULT_HOT_W = 32
_WORD_COUNT_LIMIT = 4096

_KNOBS = {
    "queue_mode": ("tiered3", "tiered", "flat", "reference"),
    "dispatch_mode": ("switch", "masked", "fused"),
    "validate": ("off", "cheap", "full"),
    "overflow": ("drop", "error", "spill"),
    "loop": ("eager", "captured"),
}

# Per queue mode: (has_pending, next_time, insert, occupancy).  The
# guard counts real events (``size`` also counts overflow ghosts): the
# tiered queues from their tier counters, the flat queue from its head
# slot (its occupied slots are a sorted prefix), the reference queue
# from the whole occupancy mask.
_QUEUE_OPS = {
    "tiered3": (tiered3_queue_has_pending, tiered3_queue_next_time,
                tiered3_queue_fill_rows, tiered3_queue_occupancy),
    "tiered": (tiered_queue_has_pending, tiered_queue_next_time,
               tiered_queue_fill_rows, tiered_queue_occupancy),
    "flat": (lambda q: q.types[0] >= 0, device_queue_next_time,
             device_queue_fill_rows, device_queue_occupancy),
    "reference": (lambda q: torch.any(q.types >= 0),
                  device_queue_next_time_ref, device_queue_push_rows,
                  device_queue_occupancy),
}


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card, which must be present: there is no
    fallback to the CPU, which a caller must ask for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "engine on the CPU")
    return dev


class Simulator:
    """Host-runtime facade over registry + queue + scheduler.

    ``device`` is where the composed words run (``None``: the CUDA card,
    which must be present); ``jit_handlers`` picks ``torch.compile`` of
    each word (or each handler, unbatched) or the eager route.  Prefer
    ``SimProgram.build(backend="host", ...)``.
    """

    @classmethod
    def from_program(cls, program, *, composer: str = "lazy",
                     state_spec=None, arg_spec=None, device=None,
                     jit_handlers: bool = True) -> "Simulator":
        """The host backend of a frozen SimProgram, with the program's
        scheduled initial events already queued."""
        cfg = program.config
        sim = cls(
            program.host_registry(),
            max_batch_len=cfg.max_batch_len,
            codec=cfg.codec,
            composer=composer,
            state_spec=state_spec,
            arg_spec=arg_spec,
            device=device,
            jit_handlers=jit_handlers,
        )
        for (t, type_id, arg) in program.scheduled_events():
            sim.queue.push(t, type_id, arg)
        return sim

    def __init__(self, registry: EventRegistry, *, max_batch_len: int = 4,
                 codec: str = "dense", composer: str = "lazy",
                 state_spec=None, arg_spec=None, device=None,
                 jit_handlers: bool = True):
        registry.freeze()
        self.registry = registry
        self.codec = make_codec(codec, len(registry), max_batch_len)
        kw = dict(device=device, jit_handlers=jit_handlers)
        if composer == "lazy":
            self.composer = LazyComposer(registry, self.codec, **kw)
        elif composer == "eager":
            self.composer = EagerComposer(
                registry, self.codec, state_spec=state_spec,
                arg_spec=arg_spec, **kw)
        else:
            raise ValueError(f"unknown composer {composer!r}")
        self.device = self.composer.device
        self.jit_handlers = jit_handlers
        self.queue = HostEventQueue()

    def schedule(self, time: float, type_name: str, arg: Any = None):
        et = self.registry[type_name]
        return self.queue.push(time, et.type_id, arg)

    def run(self, state, *, mode: str = "conservative",
            max_events: int | None = None) -> tuple[Any, RunStats]:
        if mode == "conservative":
            sched = ConservativeScheduler(self.registry, self.composer)
            return sched.run(state, self.queue, max_events=max_events)
        if mode == "speculative":
            sched = SpeculativeScheduler(self.registry, self.composer)
            return sched.run(state, self.queue, max_events=max_events)
        if mode == "unbatched":
            return run_unbatched(
                self.registry, state, self.queue, max_events=max_events,
                jit_handlers=self.jit_handlers, device=self.device)
        raise ValueError(f"unknown mode {mode!r}")


@dataclasses.dataclass
class DeviceEngine:
    """Builder for the on-device simulation loop.

    Preferred entry point: ``repro_torch.api.SimProgram.build(
    backend="device", ...)``.  Direct use::

        eng = DeviceEngine(registry, max_batch_len=4, capacity=1024,
                           device="cuda")
        queue = eng.initial_queue([(t, type_id, arg_vec), ...])
        state, queue, stats = eng.run(state0, queue, max_batches=10_000)

    ``run`` copies ``state0`` onto the engine's device first, so
    handlers may update state tensors in place (the PHOLD example does,
    to avoid copying its per-LP counters once per event).  ``run(...,
    stats=)`` resumes a previous run's cumulative stats carry: a
    segmented run is bit-identical to an unsegmented one.

    ``loop="captured"`` runs the super-steps as replays of one captured
    CUDA graph, ``chunk`` steps a host read (see the module docstring),
    in every queue mode and under every ``dispatch_mode``, ``validate``
    and ``overflow``, and in the sharded engine; a segmented run
    (checkpoints, spill, streamed arrivals) replays one graph in all its
    segments.  Its handlers must not read the host, which raises
    :class:`repro_torch.core.capture.CaptureError` naming the handler.
    A failed capture raises; nothing falls back to the eager loop.
    """

    registry: EventRegistry
    max_batch_len: int = 4
    capacity: int = 1024
    max_emit: int = 2
    queue_mode: str = "tiered3"
    front_cap: int | None = None
    stage_cap: int | None = None
    num_runs: int | None = None
    dispatch_mode: str = "switch"
    hot_words: object = None
    validate: str = "off"
    overflow: str = "drop"
    device: object = None
    entity_handlers: dict | None = None
    loop: str = "eager"
    # Captured steps a host read (not a field: see the module docstring).
    chunk = 64
    # The step's capture mode (``capture.CAPTURE_MODES``): "global"
    # refuses an unsafe CUDA call from any thread while it captures.
    capture_mode = "global"

    def __post_init__(self):
        self.registry.freeze()
        for knob, choices in _KNOBS.items():
            if getattr(self, knob) not in choices:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r}; "
                                 f"expected one of {choices}")
        if self.overflow == "spill" and self.queue_mode != "tiered3":
            raise ValueError(
                "overflow='spill' requires queue_mode='tiered3' (got "
                f"{self.queue_mode!r}): spilled rows reabsorb through "
                "the tiered3 tagged-fill path")
        if self.hot_words is not None and self.dispatch_mode != "fused":
            raise ValueError(
                "hot_words only applies to dispatch_mode='fused' "
                f"(got dispatch_mode={self.dispatch_mode!r})")
        self.device = resolve_device(self.device)
        emit_rows = self.max_batch_len * self.max_emit
        if self.front_cap is None:
            self.front_cap = max(256, 8 * self.max_batch_len)
        self.front_cap = min(max(self.front_cap, self.max_batch_len),
                             self.capacity)
        if self.stage_cap is None:
            self.stage_cap = max(256, 8 * emit_rows)
        self.stage_cap = max(self.stage_cap, emit_rows)
        if self.num_runs is None:
            self.num_runs = 8
        self.num_runs = max(self.num_runs, 1)
        self.codec = DenseCodec(len(self.registry), self.max_batch_len)
        self.dispatch = build_switch_dispatcher(
            self.registry, self.codec, max_emit=self.max_emit)
        self._dispatch_masked = None
        self._dispatch_fused = None
        if self.dispatch_mode == "masked":
            self._dispatch_masked = build_masked_dispatcher(
                self.registry, self.codec, max_emit=self.max_emit)
        elif self.dispatch_mode == "fused":
            hot = self.hot_words
            if hot is None:
                # No profile given: the first W dense codes (shortest
                # words first; small alphabets get the full switch).
                hot = [self.codec.decode(c) for c in
                       range(min(self.codec.num_batches, _DEFAULT_HOT_W))]
            self._dispatch_fused = build_fused_dispatcher(
                self.registry, self.codec, hot, max_emit=self.max_emit)
            self.hot_words = self._dispatch_fused.hot_words
        self._track_word_counts = (
            self.codec.num_batches <= _WORD_COUNT_LIMIT)
        self._lookaheads = self.registry.lookaheads(self.device)
        self._run_branches = {}
        for ty, local in sorted((self.entity_handlers or {}).items()):
            if not 0 <= ty < len(self.registry):
                raise ValueError(
                    f"entity_handlers key {ty} is not a registered type "
                    f"id (registry has {len(self.registry)} types)")
            if self.registry[ty].returns_events:
                raise ValueError(
                    f"entity-parallel type {self.registry[ty].name!r} "
                    "must not emit events")
            self._run_branches[ty] = make_masked_run_handler(local)
        self._lanes = torch.arange(self.max_batch_len, device=self.device)
        # The captured loop: its run-branch table on the device (type ->
        # index into _run_branches' sorted types, -1 for none) and its
        # graph, kept across runs and segments of one signature.
        self._run_table = None
        if self.loop == "captured":
            table = np.full((len(self.registry),), -1, np.int32)
            for i, ty in enumerate(sorted(self._run_branches)):
                table[ty] = i
            self._run_table = torch.as_tensor(table, device=self.device)
        self._captured = None
        self.captures = 0

    @classmethod
    def from_program(cls, program, *, device=None,
                     queue_mode: str = "tiered3",
                     capacity: int | None = None,
                     front_cap: int | None = None,
                     stage_cap: int | None = None,
                     num_runs: int | None = None,
                     dispatch_mode: str = "switch",
                     hot_words=None,
                     validate: str = "off",
                     overflow: str = "drop",
                     loop: str = "eager") -> "DeviceEngine":
        """The device backend of a frozen SimProgram: its adapted
        registry, its entity-parallel handlers and its Config."""
        cfg = program.config
        return cls(
            program.device_registry(),
            max_batch_len=cfg.max_batch_len,
            capacity=cfg.capacity if capacity is None else capacity,
            max_emit=cfg.max_emit, queue_mode=queue_mode,
            front_cap=front_cap, stage_cap=stage_cap, num_runs=num_runs,
            dispatch_mode=dispatch_mode, hot_words=hot_words,
            validate=validate, overflow=overflow, device=device,
            entity_handlers=program.device_entity_handlers() or None,
            loop=loop,
        )

    def initial_queue(self, events):
        """The seed queue, built on the host and copied once."""
        if self.queue_mode == "tiered":
            return tiered_queue_from_host(
                events, self.capacity, front_cap=self.front_cap,
                stage_cap=self.stage_cap, device=self.device)
        if self.queue_mode == "tiered3":
            return tiered3_queue_from_host(
                events, self.capacity, front_cap=self.front_cap,
                stage_cap=self.stage_cap, num_runs=self.num_runs,
                device=self.device)
        return device_queue_from_host(events, self.capacity,
                                      device=self.device)

    def initial_queue_spill(self, events):
        """Seed split for ``overflow='spill'``: the lex-earliest
        ``capacity`` events (by time, then input order) seed the queue
        with their input-order seqs; the rest start in the host spill
        pool instead of being dropped.  Returns ``(queue, spill_rows,
        spill_seqs)``, the rows in emit layout ``(time, type, arg...)``."""
        events = list(events)
        n = len(events)
        if n <= self.capacity:
            return (self.initial_queue(events),
                    np.zeros((0, 2 + ARG_WIDTH), np.float32),
                    np.zeros((0,), np.int32))
        times = np.asarray([float(e[0]) for e in events], np.float64)
        types = np.asarray([e[1] for e in events], np.int32)
        args = np.zeros((n, ARG_WIDTH), np.float32)
        for i, e in enumerate(events):
            if e[2] is not None:
                args[i] = np.asarray(e[2], np.float32)
        order = np.lexsort((np.arange(n), times))
        keep = np.sort(order[:self.capacity]).astype(np.int32)
        spill = np.sort(order[self.capacity:]).astype(np.int32)
        q = tiered3_queue_from_columns(
            times[keep], types[keep], args[keep], keep, self.capacity,
            front_cap=self.front_cap, stage_cap=self.stage_cap,
            num_runs=self.num_runs, device=self.device)
        # Spilled events own seqs too: the counter must already be past
        # every seed seq, queued or spilled.
        q = q._replace(next_seq=torch.full_like(q.next_seq, n))
        rows = np.zeros((spill.size, 2 + ARG_WIDTH), np.float32)
        rows[:, 0] = times[spill]
        rows[:, 1] = types[spill]
        rows[:, 2:] = args[spill]
        return q, rows, spill

    def place_queue(self, queue):
        """Re-place a restored queue's leaves for this engine: the
        single-queue engines' as they are; the sharded engine's
        ``placement="devices"`` places them on its mesh."""
        return queue

    def queue_occupancy(self, queue) -> torch.Tensor:
        """Real pending events (``size`` also counts ghosts)."""
        return _QUEUE_OPS[self.queue_mode][3](queue)

    def queue_next_time(self, queue) -> torch.Tensor:
        """The earliest pending timestamp (``inf`` when empty)."""
        return _QUEUE_OPS[self.queue_mode][1](queue)

    def absorb_rows(self, queue, rows, seqs, insert=None):
        """Absorb externally keyed rows (stream arrivals, reabsorbed
        spills) where ``insert`` is set; the caller guarantees they fit."""
        if self.queue_mode != "tiered3":
            raise ValueError(
                "absorb_rows requires queue_mode='tiered3', got "
                f"{self.queue_mode!r}")
        return tiered3_queue_absorb_rows(queue, rows, seqs, insert=insert)

    def initial_run_stats(self) -> dict:
        """The stats carry: host ints for the counters the host already
        knows, device tensors for the rest."""
        dev = self.device
        stats = {
            "batches": 0,
            "events": 0,
            "emitted": torch.zeros((), dtype=torch.int32, device=dev),
            "time": torch.zeros((), dtype=torch.float32, device=dev),
        }
        if self._track_word_counts:
            stats["word_counts"] = torch.zeros(
                (self.codec.num_batches,), dtype=torch.int32, device=dev)
        if self.validate != "off":
            stats["fault_word"] = torch.zeros((), dtype=torch.int32,
                                              device=dev)
        if self.overflow == "spill":
            rows = self.dispatch.empty_emits(dev)
            stats["spill_rows"] = rows
            stats["spill_seqs"] = torch.zeros((rows.shape[0],),
                                              dtype=torch.int32, device=dev)
            stats["spill_n"] = torch.zeros((), dtype=torch.int32, device=dev)
            stats["bound_t"] = torch.full((), INF, dtype=torch.float32,
                                          device=dev)
            stats["bound_seq"] = torch.full((), I32_MAX, dtype=torch.int32,
                                            device=dev)
        return stats

    def _cheap_fault_bits(self, queue) -> torch.Tensor:
        """The per-super-step fault word of this queue mode."""
        if self.queue_mode == "tiered3":
            return _validate.tiered3_fault_bits(
                queue, local=(self.overflow == "spill"))
        if self.queue_mode == "tiered":
            return _validate.tiered_fault_bits(queue)
        return _validate.flat_fault_bits(
            queue, sorted_layout=self.queue_mode == "flat")

    def _extract(self, queue, t_end, bound):
        """The window of this queue mode: ``(q', ts, tys, args,
        length)``."""
        k = self.max_batch_len
        if self.queue_mode == "tiered3":
            return tiered3_queue_extract(queue, k, self._lookaheads, t_end,
                                         bound=bound)
        extract = {"tiered": tiered_queue_extract,
                   "flat": device_queue_extract,
                   "reference": device_queue_extract_ref}[self.queue_mode]
        return extract(queue, k, self._lookaheads, t_end)

    def _spill_insert(self, queue, emits, stats):
        """Insert the emit rows that fit; divert the rest to the spill
        buffer in the stats carry.  Every valid row draws its seq from
        the one counter, so a reabsorbed row keeps its place in the
        total ``(time, seq)`` order; the fence tightens to the
        lex-earliest spilled key.  Returns ``(queue, delta)``, the
        spill fields of the new stats."""
        R = emits.shape[0]
        valid = emits[:, 1] >= 0
        vrank = _prefix_rank(valid)
        num_valid = torch.sum(valid).to(torch.int32)
        base_seq = queue.next_seq
        seq_r = base_seq + vrank
        occ = tiered3_queue_occupancy(queue)
        fits = valid & (occ + vrank < self.capacity)
        spilled = valid & ~fits
        queue = tiered3_queue_fill_rows_tagged(queue, emits, seq_r, fits)
        # The tagged fill advances next_seq past INSERTED rows only;
        # spilled rows still own theirs.
        queue = queue._replace(next_seq=base_seq + num_valid)
        dst = torch.where(spilled, _prefix_rank(spilled), R)
        n_spill = torch.sum(spilled).to(torch.int32)
        min_t = torch.min(torch.where(spilled, emits[:, 0], INF))
        min_s = torch.min(torch.where(spilled & (emits[:, 0] == min_t),
                                      seq_r, I32_MAX))
        take = (min_t < stats["bound_t"]) | (
            (min_t == stats["bound_t"]) & (min_s < stats["bound_seq"]))
        delta = {
            "spill_rows": _scatter_rows(stats["spill_rows"], dst, emits),
            "spill_seqs": _scatter_rows(stats["spill_seqs"], dst, seq_r),
            "spill_n": stats["spill_n"] + n_spill,
            "bound_t": torch.where(take, min_t, stats["bound_t"]),
            "bound_seq": torch.where(take, min_s, stats["bound_seq"]),
        }
        return queue, delta

    def _dispatch_window(self, state, ts, args, types, length, code):
        """Dispatch one window (host ``types``, ``length`` and ``code``);
        returns (state, emits).  Every route runs the same handler
        sequence, so the choice never changes a result."""
        run = self._run_branches.get(types[0]) if length else None
        if run is not None and all(ty == types[0]
                                   for ty in types[1:length]):
            COUNTS["run_path"] += 1
            state = run(state, ts, args, i32_sat(args[:, 0]),
                        self._lanes < length)
            return state, self.dispatch.empty_emits(ts.device)
        if self.dispatch_mode == "masked":
            return self._dispatch_masked(state, ts, types, args, length)
        if self.dispatch_mode == "fused":
            return self._dispatch_fused(code, state, ts, types, args,
                                        length)
        return self.dispatch(code, state, ts, args)

    def _guard(self, ok, queue, stats, fenced, next_key):
        """AND the robustness modes' stop conditions into the guard
        ``ok``: one host read carries them all."""
        if self.validate != "off":
            ok = ok & (stats["fault_word"] == 0)
        if self.overflow == "error":
            ok = ok & (queue.dropped == 0)
        if fenced:
            nk_t, nk_s = next_key
            ok = ok & ((nk_t < stats["bound_t"]) | (
                (nk_t == stats["bound_t"]) & (nk_s < stats["bound_seq"])))
        if self.overflow == "spill":
            ok = ok & (stats["spill_n"] == 0)
        return ok

    def _account(self, stats, ts, emits, n, code, prev_time, bits=None):
        """The stats carry after one super-step (in place), with the
        queue's fault word ``bits`` when validating."""
        stats["batches"] += 1
        stats["events"] += n
        stats["emitted"] = stats["emitted"] + torch.sum(
            emits[:, 1] >= 0).to(torch.int32)
        stats["time"] = torch.maximum(stats["time"], ts[max(n - 1, 0)])
        if self._track_word_counts:
            stats["word_counts"][code] += 1
        if bits is not None:
            if n:
                bits = bits | torch.where(ts[0] < prev_time,
                                          FAULT_CLOCK, 0).to(torch.int32)
            stats["fault_word"] = stats["fault_word"] | bits

    def _super_steps(self, state, queue, stats, max_batches, t_end, fenced):
        """The loop: super-steps until the guard stops or ``max_batches``
        have run in total.  Updates ``stats`` in place; returns
        ``(state, queue)``."""
        has_pending, next_time, insert, _ = _QUEUE_OPS[self.queue_mode]
        validate_on = self.validate != "off"
        spill = self.overflow == "spill"
        k = self.max_batch_len
        while stats["batches"] < max_batches:
            ok = has_pending(queue) & (next_time(queue) <= t_end)
            ok = self._guard(ok, queue, stats, fenced,
                             tiered3_queue_next_key(queue) if fenced
                             else None)
            if not host_read(ok):
                break
            bound = ((stats["bound_t"], stats["bound_seq"]) if fenced
                     else None)
            queue, ts, tys, args, length = self._extract(queue, t_end, bound)
            window = host_list(torch.cat([tys, length.reshape(1)]))
            n = window[-1]
            # encode_jnp gives code 0 for an empty window.
            code = self.codec.encode(window[:n]) if n else 0
            state, emits = self._dispatch_window(
                state, ts, args, window[:k], n, code)
            prev_time = stats["time"]
            if spill:
                queue, delta = self._spill_insert(queue, emits, stats)
                stats.update(delta)
            else:
                queue = insert(queue, emits)
            self._account(stats, ts, emits, n, code, prev_time,
                          self._cheap_fault_bits(queue) if validate_on
                          else None)
        return state, queue

    # -- the captured loop ---------------------------------------------------
    def _dispatch_window_device(self, state, ts, tys, args, length, code):
        """:meth:`_dispatch_window` with every choice made on the device
        (``tys``, ``length`` and ``code`` device tensors): JAX's
        ``lax.cond(is_run, run_path, switch_path)`` as one
        :func:`~repro_torch.core.capture.select` over the run branches
        and the dispatch mode's path."""
        def dispatch(c):
            if self.dispatch_mode == "masked":
                return self._dispatch_masked.on_device(c[0], ts, tys, args,
                                                       length)
            if self.dispatch_mode == "fused":
                return self._dispatch_fused.on_device(code, c[0], ts, tys,
                                                      args, length)
            return self.dispatch.on_device(code, c[0], ts, args)

        emits = self.dispatch.empty_emits(ts.device)
        if not self._run_branches:
            return dispatch((state, emits))
        n_run = len(self._run_branches)
        in_window = self._lanes < length
        branch = self._run_table.index_select(0, torch.clamp(
            tys[:1], 0, len(self.registry) - 1).long()).reshape(())
        is_run = ((length > 0) & (branch >= 0)
                  & torch.all(torch.where(in_window, tys == tys[0], True)))

        def run_path(fn):
            def go(c):
                bump("run_path")
                return (fn(c[0], ts, args, i32_sat(args[:, 0]), in_window),
                        c[1])
            return go

        paths = [run_path(self._run_branches[ty])
                 for ty in sorted(self._run_branches)]
        return select(torch.where(is_run, branch, n_run), paths + [dispatch],
                      (state, emits))

    def _active(self, queue, stats, max_batches, t_end):
        """The captured loop's guard on the device: JAX's ``cond`` (the
        eager loop's guard read and its ``batches < max_batches``).  A
        carry with the fence (``bound_t``) is a fenced run's."""
        has_pending, next_time, _, _ = _QUEUE_OPS[self.queue_mode]
        ok = (has_pending(queue) & (next_time(queue) <= t_end)
              & (stats["batches"] < max_batches))
        fenced = "bound_t" in stats
        return self._guard(ok, queue, stats, fenced,
                           tiered3_queue_next_key(queue) if fenced else None)

    def _step_captured(self, carry, t_end):
        """One super-step of the captured loop: the whole body under
        ``when(active)``, so a step past the end is an exact no-op.
        ``carry`` holds ``state``, ``queue``, ``stats`` (``batches`` and
        ``events`` as int64 device scalars), ``active`` and
        ``max_batches``; returns the next carry."""
        return cond(carry["active"],
                    lambda c: self._step_body(c, t_end), carry)

    def _step_body(self, carry, t_end):
        state, queue = carry["state"], carry["queue"]
        stats = dict(carry["stats"])
        bound = ((stats["bound_t"], stats["bound_seq"]) if "bound_t" in stats
                 else None)
        queue, ts, tys, args, length = self._extract(queue, t_end, bound)
        code = self._code_device(tys, length)
        state, emits = self._dispatch_window_device(state, ts, tys, args,
                                                    length, code)
        prev_time = stats["time"]
        if self.overflow == "spill":
            queue, delta = self._spill_insert(queue, emits, stats)
            stats.update(delta)
        else:
            queue = _QUEUE_OPS[self.queue_mode][2](queue, emits)
        self._account_device(stats, ts, emits, length, code, prev_time,
                             self._cheap_fault_bits(queue)
                             if self.validate != "off" else None)
        return {"state": state, "queue": queue, "stats": stats,
                "active": self._active(queue, stats, carry["max_batches"],
                                       t_end),
                "max_batches": carry["max_batches"]}

    def _code_device(self, tys, length):
        """The window's word code on the device, where the dispatch or
        the word histogram needs it."""
        if self.dispatch_mode != "masked" or self._track_word_counts:
            return self.codec.encode_torch(tys, length)
        return None

    def _account_device(self, stats, ts, emits, length, code, prev_time,
                        bits=None):
        """:meth:`_account` with ``length`` and ``code`` device tensors
        and ``batches``/``events`` device scalars (in place)."""
        stats["batches"] = stats["batches"] + 1
        stats["events"] = stats["events"] + length
        stats["emitted"] = stats["emitted"] + torch.sum(
            emits[:, 1] >= 0).to(torch.int32)
        last = ts.index_select(0, torch.clamp(length - 1, min=0).long()
                               .reshape(1)).reshape(())
        stats["time"] = torch.maximum(stats["time"], last)
        if self._track_word_counts:
            stats["word_counts"] = stats["word_counts"].index_add(
                0, code.long().reshape(1),
                torch.ones(1, dtype=torch.int32, device=ts.device))
        if bits is not None:
            bits = bits | torch.where(
                (length > 0) & (ts[0] < prev_time), FAULT_CLOCK, 0
            ).to(torch.int32)
            stats["fault_word"] = stats["fault_word"] | bits

    def _super_steps_captured(self, state, queue, stats, max_batches,
                              t_end):
        """The captured loop: chunks of ``chunk`` steps, then one host
        read of ``(active, batches, events)`` and the capture's counters.
        On a CUDA device the step is one CUDA graph, captured once a
        signature (:mod:`repro_torch.core.capture`) and replayed; on the
        CPU the same step runs eagerly with its predicates read on the
        host.  Updates ``stats`` in place; returns ``(state, queue)``."""
        dev = self.device
        carry = {
            "state": state,
            "stats": {k: (torch.tensor(v, dtype=torch.int64, device=dev)
                          if k in ("batches", "events") else v)
                      for k, v in stats.items()},
            "max_batches": torch.tensor(max_batches, dtype=torch.int64,
                                        device=dev),
        }
        carry["queue"] = self._carry_queue(queue, carry["stats"])
        carry["active"] = self._active(carry["queue"], carry["stats"],
                                       carry["max_batches"], t_end)
        if dev.type == "cuda":
            carry = self._chunks_on_card(carry, t_end)
        else:
            carry = self._chunks_emulated(carry, t_end)
        for k, v in carry["stats"].items():
            stats[k] = v
        return carry["state"], self._queue_of_carry(carry["queue"])

    def _carry_queue(self, queue, stats):
        """The queue as the captured step carries it (the sharded
        engine's devices placement carries more); ``stats`` is the
        carry's."""
        return queue

    def _queue_of_carry(self, queue):
        """The queue :meth:`run` returns, from the carry's form."""
        return queue

    def _chunk_read(self, carry, extra=None) -> list:
        """The chunk's one host read: ``[active, batches, events,
        *extra]``."""
        st = carry["stats"]
        parts = [carry["active"].to(torch.int64).reshape(1),
                 st["batches"].reshape(1), st["events"].reshape(1)]
        if extra is not None:
            parts.append(extra)
        return host_list(torch.cat(parts))

    def _chunks_emulated(self, carry, t_end):
        # ``captures`` counts the graphs a card would capture for these
        # carries (one a signature, as :meth:`_chunks_on_card` keys it),
        # so a CPU run shows where a card run would capture again.
        key = (t_end, signature(carry))
        if self._captured is None or self._captured[0] != key:
            self._captured = (key, None, None)
            self.captures += 1
        ctx = EmulateContext()
        while True:
            with step_context(ctx):
                for _ in range(self.chunk):
                    carry = self._step_captured(carry, t_end)
            vals = self._chunk_read(carry)
            if not vals[0]:
                break
        carry["stats"] = dict(carry["stats"], batches=vals[1],
                              events=vals[2])
        return carry

    def _chunks_on_card(self, carry, t_end):
        key = (t_end, signature(carry))
        if self._captured is None or self._captured[0] != key:
            self._captured = None
            static = tree_map(lambda x: x.clone(), carry)
            t0 = time.perf_counter()
            self._warm_up(static, t_end)
            step = capture_graph(
                self.device, lambda: self._step_captured(static, t_end),
                mode=self.capture_mode)
            self.capture_seconds = time.perf_counter() - t0
            self.captures += 1
            self._captured = (key, static, step)
        else:
            _, static, step = self._captured
            write_back(static, carry)
        ctx = step.ctx
        while True:
            for _ in range(self.chunk):
                step.replay()
            vals = self._chunk_read(static, ctx.counters[:ctx.used])
            ctx.fold(vals[3:], self.chunk)
            if not vals[0]:
                break
        out = tree_map(lambda x: x.clone(), static)
        out["stats"] = dict(out["stats"], batches=vals[1], events=vals[2])
        return out

    def _warm_up(self, static, t_end):
        """Before the capture, on a side stream: one step run eagerly on
        copies of the carry (device tables and kernel plans are made
        here, outside any graph, and a handler that reads the host
        raises), then one relaxed capture of the whole step that is
        thrown away (every branch's first launches happen there).  The
        counts both make are taken back."""
        counts, launches = dict(COUNTS), launch_totals()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = tree_map(lambda x: x.clone(), static)
            with step_context(EmulateContext()):
                # The body even past the end: its tables are needed.
                self._step_body(scratch, t_end)
            del scratch
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        capture_graph(self.device,
                      lambda: self._step_captured(static, t_end),
                      mode="relaxed")
        COUNTS.clear()
        COUNTS.update(counts)
        set_launches(launches)

    def run(self, state, queue, *, max_batches: int = 1 << 30,
            t_end: float = float("inf"), stats: dict | None = None):
        """Run until the pending set drains, ``max_batches`` super-steps
        have run in total, or the next event lies past ``t_end`` (the
        window is capped at ``t_end``, so exactly the events at or before
        it execute).  ``stats`` resumes a previous run's cumulative
        carry (``max_batches`` then caps the total).  Returns ``(state,
        queue, stats)``.

        With ``validate != 'off'`` a set fault bit raises
        :class:`EngineFaultError` naming the invariant and the
        super-step; with ``overflow='error'`` the first dropped event
        does the same."""
        t_end = _f32(t_end)
        dev = self.device
        state = tree_map(lambda x: x.to(dev, copy=True), state)
        if stats is None:
            stats = self.initial_run_stats()
        else:
            # The carry is updated in place below (word_counts): work on
            # a copy.  "dropped" lives on the queue, not in the carry.
            stats = {k: (v.to(dev, copy=True) if torch.is_tensor(v)
                         else int(v))
                     for k, v in stats.items() if k != "dropped"}
        validate_on = self.validate != "off"
        error = self.overflow == "error"
        spill = self.overflow == "spill"
        fenced = spill or "bound_t" in stats
        if fenced and self.queue_mode != "tiered3":
            raise ValueError(
                "the admission fence (overflow='spill' / streamed "
                "arrivals) requires queue_mode='tiered3', got "
                f"{self.queue_mode!r}")
        entry_batches = stats["batches"]
        if validate_on:
            # Entry audit: a queue corrupted between segments trips the
            # guard before any event executes.
            stats["fault_word"] = (stats["fault_word"]
                                   | self._cheap_fault_bits(queue))
        syncs0 = COUNTS["host_syncs"]
        if self.loop == "captured":
            state, queue = self._super_steps_captured(
                state, queue, stats, max_batches, t_end)
        else:
            state, queue = self._super_steps(state, queue, stats,
                                             max_batches, t_end, fenced)
        # The reads the super-steps made (the guard's last read included),
        # apart from those of the segment boundaries around them.
        COUNTS["loop_syncs"] += COUNTS["host_syncs"] - syncs0
        # A placed queue's counter is replicated: this rank's copy.
        dropped = stats["dropped"] = to_local(queue.dropped)
        if error or validate_on:
            dropped, word = host_list(torch.stack([
                dropped, stats["fault_word"] if validate_on else dropped]))
            if error and dropped > 0:
                raise EngineFaultError(
                    FAULT_OVERFLOW, stats["batches"],
                    detail=(f"{dropped} event(s) overflowed the "
                            f"capacity-{self.capacity} queue"))
            if validate_on and word != 0:
                # The guard freezes the loop the moment the word sets:
                # the last super-step set it, or the entry audit when no
                # super-step ran.
                final_b = stats["batches"]
                raise EngineFaultError(
                    word, final_b - 1 if final_b > entry_batches
                    else final_b)
        if self.validate == "full":
            _validate.raise_on_findings(
                _validate.full_audit(queue, local=spill),
                step=stats["batches"])
        return state, queue, stats
