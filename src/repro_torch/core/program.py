"""`SimProgram`: one declarative model definition (PyTorch port).

Counterpart of :mod:`repro.core.program` for the device backend: a
model is declared once —

    prog = SimProgram("mm1", config=Config(max_batch_len=4))

    @prog.handler("ARRIVE", lookahead=1.0, emits=True)
    def arrive(state, t, arg):
        ...
        return state, emits          # f32[max_emit, 2 + ARG_WIDTH]

    prog.schedule(0.0, "ARRIVE")

— and compiled with ``prog.build(backend="device")``, which runs on the
CUDA card unless ``device=`` names another device (``"cpu"`` for the
tests).  ``CompiledSim.run(state0)`` returns a :class:`RunResult`.

An emitting handler returns ``(delay, type_id, arg...)`` rows with the
delay relative to its own timestamp; the device adapter rewrites column
0 to the absolute time ``t + delay``.  Handlers take and return torch
tensors on the run's device; they may update state tensors in place,
because the engine runs on its own copy of the initial state.

An entity-parallel type (``@prog.entity_handler``) declares an
entity-local handler; a window that is a run of that type runs as one
``torch.func.vmap`` over its entities (:mod:`repro_torch.core.vectorize`),
and a mixed window runs it as gather, apply, scatter.

``CompiledSim.run`` runs SEGMENTED when it is asked to (the JAX
package's ``_run_device`` and ``_segment_loop``): ``checkpoint_every=N``
snapshots the engine's whole carry (state, every queue tier, the
cumulative stats) every ``N`` super-steps through
:class:`repro_torch.checkpoint.manager.CheckpointManager`,
``resume_from=`` restores one and continues bit-identically,
``overflow="spill"`` parks the events that do not fit in a host pool
reabsorbed at segment boundaries under the engine's lex fence, and
``arrivals=`` streams an :class:`repro_torch.stream.ArrivalSource` into
the run, block by block, under the same fence.  A closed run without
these knobs is one engine call.

``build(queue_mode=...)`` takes every queue mode of the JAX device
backend, and ``build(shards=N)`` the sharded engine, with
``placement="serial"`` (every shard in this process) or
``placement="devices"`` (one process a shard over ``torch.distributed``:
every rank of a default process group of N ranks builds and runs the
same program); a sharded run is segmented as a single-queue one is
(checkpoints, streamed arrivals), except ``overflow="spill"``, which
JAX's sharded engine refuses too.

``build(backend="host", scheduler=, composer=)`` is the paper's own
runtime: a Python event loop over a heap (:mod:`repro_torch.core.
scheduler`) that runs one composed program per batch word, each handed
to ``torch.compile`` unless ``jit_handlers=False``.  The host adapter
returns an emitting handler's rows as ``(delay, type, arg)`` tuples;
the schedulers read a batch's emissions once and anchor each at its
emitter's time on the host.

``build(check="warn"|"error")`` runs the static analyzer
(:mod:`repro_torch.analysis`) over the model before a single event
executes, and ``hot_words="static"`` takes the fused hot set from its
reachable compositions.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.events import ARG_WIDTH, EventRegistry
from repro_torch.core.queue import (
    COUNTS,
    I32_MAX,
    HostEventQueue,
    host_read,
    i32_sat,
)
from repro_torch.core.tree import tree_map
from repro_torch.core.vectorize import entity_index

EMIT_WIDTH = 2 + ARG_WIDTH

_HOST_SCHEDULERS = ("conservative", "speculative", "unbatched")
_CHECK_MODES = ("off", "warn", "error")


class AnalysisError(ValueError):
    """``build(check="error")`` found error-severity static findings."""


@dataclasses.dataclass(frozen=True)
class Config:
    """Shared capacity/batch knobs (the JAX ``Config``).  ``codec``
    selects the host codec; the device engine always uses the dense
    codec."""

    max_batch_len: int = 4
    capacity: int = 1024
    max_emit: int = 2
    codec: str = "dense"

    def __post_init__(self):
        if self.max_batch_len < 1:
            raise ValueError("max_batch_len must be >= 1")
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        if self.max_emit < 1:
            raise ValueError("max_emit must be >= 1")
        if self.codec not in ("dense", "paper"):
            raise ValueError(f"unknown codec {self.codec!r}")


@dataclasses.dataclass(frozen=True)
class _HandlerSpec:
    type_id: int
    name: str
    fn: Callable
    lookahead: float
    emits: bool
    entity: bool = False


def normalize_arg(arg, arg_width: int = ARG_WIDTH) -> np.ndarray:
    """Canonicalize an event argument to the fixed ``f32[ARG_WIDTH]``
    record (None -> zeros; scalars/short vectors are zero-padded)."""
    if arg is None:
        return np.zeros((arg_width,), np.float32)
    a = np.asarray(arg, np.float32).reshape(-1)
    if a.size > arg_width:
        raise ValueError(
            f"event arg has {a.size} elements; ARG_WIDTH is {arg_width}")
    out = np.zeros((arg_width,), np.float32)
    out[: a.size] = a
    return out


def state_from_numpy(tree, device) -> Any:
    """A handler state tree of numpy arrays / scalars as tensors on
    ``device``.  uint32 leaves become int64 holding the same value (the
    port keeps u32 arithmetic in int64 with an explicit ``& 0xFFFFFFFF``
    mask); every other dtype is kept."""

    def leaf(x):
        a = np.asarray(x)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.tensor(a, device=device)

    return tree_map(leaf, tree)


def _check_emits(emits, max_emit: int, name: str) -> torch.Tensor:
    emits = torch.as_tensor(emits, dtype=torch.float32)
    if tuple(emits.shape) != (max_emit, EMIT_WIDTH):
        raise ValueError(
            f"handler {name!r} must return emits of shape "
            f"({max_emit}, {EMIT_WIDTH}) = (config.max_emit, 2+ARG_WIDTH) "
            f"rows of (delay, type, arg...); got {tuple(emits.shape)}")
    return emits


def _adapt_emits_host(fn: Callable, max_emit: int, name: str) -> Callable:
    """Portable delay rows -> host ``(delay, type, arg)`` tuples.

    The tuples keep device tensors; the schedulers read a batch's
    tuples to the host in one read after the batch and skip ν-rows
    (type < 0)."""

    @functools.wraps(fn)
    def host_handler(state, t, arg):
        state, emits = fn(state, t, arg)
        emits = _check_emits(emits, max_emit, name)
        new = [(emits[i, 0], emits[i, 1], emits[i, 2:])
               for i in range(max_emit)]
        return state, new

    host_handler.returns_events = True
    return host_handler


def _adapt_emits_device(fn: Callable, max_emit: int, name: str) -> Callable:
    """Portable delay rows -> on-device absolute-time rows."""

    @functools.wraps(fn)
    def device_handler(state, t, arg):
        state, emits = fn(state, t, arg)
        emits = _check_emits(emits, max_emit, name)
        times = torch.where(emits[:, 1] >= 0, t + emits[:, 0], 0.0)
        out = emits.clone()
        out[:, 0] = times
        return state, out

    device_handler.returns_events = True
    return device_handler


def _sequential_from_entity(local: Callable, name: str) -> Callable:
    """The whole-state sequential handler of an entity-local one:
    gather the entity row (``arg[0]``), apply, scatter it back (in
    place).  Mixed windows dispatch this form; the engine's vmapped run
    path applies the same local handler per lane, so the two routes are
    bit-identical."""

    @functools.wraps(local)
    def handler(state, t, arg):
        arg = torch.as_tensor(arg, dtype=torch.float32)
        eid = i32_sat(arg[0]).to(torch.int64).reshape(1)

        rows = {}

        def row(leaf):
            # JAX's indexing (the run path's): the scatter drops an id
            # still out of range, here by writing the row back as it is.
            # Once an entity count, not once a leaf.
            n = leaf.shape[0]
            if n not in rows:
                rows[n] = entity_index(eid, n)
            return rows[n]

        sub = tree_map(lambda leaf: leaf.index_select(0, row(leaf)[0])[0],
                       state)
        out = local(sub, t, arg)

        def put(leaf, new):
            at, inside = row(leaf)
            new = torch.where(inside.reshape(()), new.to(leaf.dtype),
                              leaf.index_select(0, at)[0])
            return leaf.index_copy_(0, at, new.unsqueeze(0))

        return tree_map(put, state, out)

    handler.__name__ = f"entity_seq_{name}"
    return handler


@dataclasses.dataclass(frozen=True)
class RunResult:
    """Normalized result of one :meth:`CompiledSim.run`, the JAX
    ``RunResult``.  ``events``/``batches``/``dropped``/``final_time``
    mean the same on every backend (``dropped`` is always 0 on the
    host's unbounded heap; ``rollbacks`` is non-zero only under the
    speculative scheduler); ``raw`` keeps the backend's own stats (the
    device carry, or the host's :class:`~repro_torch.core.scheduler.
    RunStats`).  ``emitted``, ``pending``, ``spilled``, ``ingested`` and
    ``shed`` complete the conservation law ``seeded + ingested +
    emitted == events + pending + dropped + spilled + shed`` on the
    device; ``fault_word``/``fault_step`` are the auditor's bits
    (``0``/``-1`` when clean or ``validate="off"``)."""

    state: Any
    events: int
    batches: int
    dropped: int
    final_time: float
    rollbacks: int = 0
    raw: Any = None
    word_counts: Any = None
    emitted: int = 0
    pending: int = 0
    spilled: int = 0
    fault_word: int = 0
    fault_step: int = -1
    ingested: int = 0
    shed: int = 0

    @property
    def mean_batch_length(self) -> float:
        return self.events / self.batches if self.batches else 0.0

    def stats(self) -> dict:
        return {
            "events": self.events,
            "batches": self.batches,
            "dropped": self.dropped,
            "final_time": self.final_time,
            "rollbacks": self.rollbacks,
            "mean_batch_length": self.mean_batch_length,
            "emitted": self.emitted,
            "pending": self.pending,
            "spilled": self.spilled,
            "fault_word": self.fault_word,
            "fault_step": self.fault_step,
            "ingested": self.ingested,
            "shed": self.shed,
        }


class SimProgram:
    """Declarative model: event alphabet + lookaheads + initial events."""

    def __init__(self, name: str = "sim", config: Config | None = None):
        self.name = name
        self.config = config or Config()
        self._specs: list[_HandlerSpec] = []
        self._by_name: dict[str, _HandlerSpec] = {}
        self._schedule: list[tuple[float, int, np.ndarray]] = []
        self._frozen = False
        self._device_registry: EventRegistry | None = None
        self._host_registry: EventRegistry | None = None
        self._example_state = None
        self._entries: set[str] = set()

    def register(self, name: str, fn: Callable, *,
                 lookahead: float = float("inf"), emits: bool = False,
                 entity: bool = False) -> _HandlerSpec:
        """Register one event type; ``emits=True`` handlers follow the
        portable fixed-record delay convention, ``entity=True``
        handlers are entity-local and must not emit."""
        if self._frozen:
            raise RuntimeError(
                "SimProgram is frozen; register all event types before "
                "build() (paper §III-A: constant handler array)")
        if name in self._by_name:
            raise ValueError(f"event type {name!r} already registered")
        if entity and emits:
            raise ValueError(
                f"entity-parallel type {name!r} must not emit events "
                "(vmapped run dispatch has no emission lanes)")
        spec = _HandlerSpec(type_id=len(self._specs), name=name, fn=fn,
                            lookahead=float(lookahead), emits=bool(emits),
                            entity=bool(entity))
        self._specs.append(spec)
        self._by_name[name] = spec
        return spec

    def handler(self, name: str | Callable | None = None, *,
                lookahead: float = float("inf"), emits: bool = False):
        """Decorator form: ``@prog.handler("ARRIVE", lookahead=1.0,
        emits=True)`` (or bare ``@prog.handler``)."""
        if callable(name):
            self.register(name.__name__, name)
            return name

        def wrap(fn):
            self.register(name or fn.__name__, fn, lookahead=lookahead,
                          emits=emits)
            return fn

        return wrap

    def entity_handler(self, name: str | Callable | None = None, *,
                       lookahead: float = float("inf")):
        """Decorator registering an entity-parallel type.  The function
        maps one entity's slice, ``(entity_state, t, arg) ->
        entity_state``, with ``arg[0]`` the entity index and every state
        leaf carrying the entity dimension on axis 0.  It must be
        functional (no ``.item()``, no Python branch on a tensor, no
        in-place update of its inputs): runs of the type go through
        ``torch.func.vmap``."""
        if callable(name):
            self.register(name.__name__, name, entity=True)
            return name

        def wrap(fn):
            self.register(name or fn.__name__, fn, lookahead=lookahead,
                          entity=True)
            return fn

        return wrap

    def schedule(self, time: float, name: str, arg: Any = None) -> None:
        """Add one initial event (by type name)."""
        if name not in self._by_name:
            raise KeyError(f"unknown event type {name!r}; registered: "
                           f"{sorted(self._by_name)}")
        self._schedule.append(
            (float(time), self._by_name[name].type_id, normalize_arg(arg)))

    def schedule_many(
        self, events: Iterable[tuple[float, str] | tuple[float, str, Any]]
    ) -> None:
        for ev in events:
            self.schedule(*ev)

    def scheduled_events(self) -> list[tuple[float, int, np.ndarray]]:
        return list(self._schedule)

    def external_entry(self, *names: str) -> "SimProgram":
        """Declare event types injected from outside the program (an
        arrival stream, ``run(events=...)`` seeds), the roots the static
        analyzer adds to the schedule's."""
        for name in names:
            if name not in self._by_name:
                raise KeyError(f"unknown event type {name!r}; registered: "
                               f"{sorted(self._by_name)}")
            self._entries.add(name)
        return self

    def example_state(self, state) -> "SimProgram":
        """Declare a representative initial state (shapes and dtypes
        only; values are never read, and its tensors may lie on any
        device).  This is what the static analyzer traces handlers
        against, what ``build(check=...)`` analyzes at build time, and
        what ``hot_words="static"`` needs.  Allowed after freeze: it is
        metadata, not a handler."""
        self._example_state = state
        return self

    def analyze(self, state=None, roots=()):
        """Run the static analyzer (:mod:`repro_torch.analysis`) over
        this program; returns a ``ProgramReport``.  ``state`` defaults
        to the declared :meth:`example_state`."""
        from repro_torch.analysis import analyze as _analyze

        return _analyze(self, state=state, roots=roots)

    def _run_check(self, mode: str, state=None):
        """Shared ``check=`` implementation: analyze, then raise
        (``"error"``) or warn (``"warn"``) on error-severity findings."""
        report = self.analyze(state=state)
        if report.errors:
            msg = (
                f"static analysis found {len(report.errors)} "
                f"error-severity finding(s) in {self.name!r}:\n  "
                + "\n  ".join(str(f) for f in report.errors)
            )
            if mode == "error":
                raise AnalysisError(msg)
            warnings.warn(msg, stacklevel=3)
        return report

    def freeze(self) -> "SimProgram":
        self._frozen = True
        return self

    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def names(self) -> list[str]:
        return [s.name for s in self._specs]

    def type_id(self, name: str) -> int:
        return self._by_name[name].type_id

    def __len__(self) -> int:
        return len(self._specs)

    def device_registry(self) -> EventRegistry:
        """Registry with emitting handlers adapted to the on-device
        absolute-time emission convention."""
        self.freeze()
        if self._device_registry is None:
            reg = EventRegistry()
            for spec in self._specs:
                fn = spec.fn
                if spec.entity:
                    fn = _sequential_from_entity(fn, spec.name)
                if spec.emits:
                    fn = _adapt_emits_device(fn, self.config.max_emit,
                                             spec.name)
                reg.register(spec.name, fn, lookahead=spec.lookahead)
            self._device_registry = reg.freeze()
        return self._device_registry

    def host_registry(self) -> EventRegistry:
        """Registry with handlers adapted to the host schedulers'
        list-of-``(delay, type, arg)`` emission convention.  Handlers
        that emit nothing are registered as they are (they take and
        return the state as they are given it: plain Python objects,
        bound methods included, as the serving control plane does)."""
        self.freeze()
        if self._host_registry is None:
            reg = EventRegistry()
            for spec in self._specs:
                fn = spec.fn
                if spec.entity:
                    fn = _sequential_from_entity(fn, spec.name)
                if spec.emits:
                    fn = _adapt_emits_host(fn, self.config.max_emit,
                                           spec.name)
                reg.register(spec.name, fn, lookahead=spec.lookahead)
            self._host_registry = reg.freeze()
        return self._host_registry

    def device_entity_handlers(self) -> dict[int, Callable]:
        """type_id -> entity-local handler, for the device engine's
        vmapped single-type-run dispatch."""
        return {s.type_id: s.fn for s in self._specs if s.entity}

    def build(self, *, backend: str = "device", device=None,
              scheduler: str = "conservative", composer: str = "lazy",
              queue_mode: str = "tiered3", shards: int | None = None,
              shard_fn=None, placement: str = "serial",
              capacity: int | None = None,
              front_cap: int | None = None, stage_cap: int | None = None,
              num_runs: int | None = None, dispatch_mode: str = "switch",
              hot_words=None, validate: str = "off",
              overflow: str = "drop", loop: str = "eager",
              check: str = "off", state_spec=None, arg_spec=None,
              check_causality: bool = False,
              window_slack: float = float("inf"),
              jit_handlers: bool = True) -> "CompiledSim":
        """Compile this model against one runtime.

        ``device=None`` runs on the CUDA card and raises when there is
        none; ``device="cpu"`` runs the same code on the CPU, with the
        kernels' plain versions.

        ``backend="device"``: ``queue_mode`` picks the pending set
        (``"tiered3"``, ``"tiered"``, ``"flat"``, ``"reference"``);
        ``shards=N`` (with an optional ``shard_fn``) runs N tiered3
        queues under :class:`repro_torch.core.sharded.ShardedDeviceEngine`,
        bit-identical to one queue; ``placement="devices"`` runs one
        shard a rank and needs a default process group of N ranks
        (``torch.distributed.init_process_group``: gloo on the CPU,
        NCCL on N cards), else raises :class:`ValueError`.
        ``hot_words`` (``dispatch_mode="fused"`` only) is a sequence of
        words, each a sequence of type names or ids, or ``"static"``:
        the first 32 compositions the static analyzer finds reachable,
        in dense-code order (needs :meth:`example_state`).

        ``backend="host"``: ``scheduler`` (``"conservative"``,
        ``"speculative"``, ``"unbatched"``) and ``composer`` (``"lazy"``,
        ``"eager"``, with ``state_spec``/``arg_spec``: example tensors or
        ``(shape, dtype)`` pairs), ``check_causality`` (conservative),
        ``window_slack`` (speculative) and ``jit_handlers``: each batch
        word (each handler, unbatched) goes through ``torch.compile``
        unless it is ``False``.

        ``loop`` (device backend): ``"eager"``, the Python loop over
        eager super-steps, or ``"captured"``, one super-step captured as
        a CUDA graph and replayed in chunks with one host read a chunk
        (:meth:`repro_torch.core.engine.DeviceEngine._super_steps_captured`;
        on the CPU the same step with its branches read on the host).
        ``"captured"`` takes the single tiered3 queue under every
        dispatch mode, ``validate`` and ``overflow="drop"``/``"error"``,
        and raises :class:`ValueError` for the rest.

        ``check`` (either backend) runs the static analyzer over the
        model: ``"error"`` raises :class:`AnalysisError` on any
        error-severity finding (unsound lookahead, malformed emit rows,
        impure handlers) before a single event executes; ``"warn"``
        reports them as warnings.  The analysis runs at build time when
        :meth:`example_state` is declared; otherwise it is deferred to
        the first :meth:`CompiledSim.run`, which checks against the
        run's own initial state before dispatching anything.

        A knob of the other backend raises :class:`ValueError`, as in
        JAX.
        """
        self.freeze()
        if check not in _CHECK_MODES:
            raise ValueError(
                f"unknown check mode {check!r}; expected one of "
                f"{_CHECK_MODES}")
        deferred_check = "off"
        report = None
        if check != "off":
            if self._example_state is not None:
                report = self._run_check(check)
            else:
                deferred_check = check
        if backend == "device":
            misdirected = {
                "scheduler": scheduler != "conservative",
                "composer": composer != "lazy",
                "state_spec": state_spec is not None,
                "arg_spec": arg_spec is not None,
                "check_causality": check_causality,
                "window_slack": window_slack != float("inf"),
                "jit_handlers": not jit_handlers,
            }
            bad = [k for k, hit in misdirected.items() if hit]
            if bad:
                raise ValueError(
                    f"{bad} are host-backend knobs; the device backend "
                    "would silently ignore them — drop them or build "
                    "with backend='host'")
        if backend == "host":
            misdirected = {
                "queue_mode": queue_mode != "tiered3",
                "shards": shards is not None,
                "shard_fn": shard_fn is not None,
                "placement": placement != "serial",
                "capacity": capacity is not None,
                "front_cap": front_cap is not None,
                "stage_cap": stage_cap is not None,
                "num_runs": num_runs is not None,
                "dispatch_mode": dispatch_mode != "switch",
                "hot_words": hot_words is not None,
                "validate": validate != "off",
                "overflow": overflow != "drop",
                "loop": loop != "eager",
            }
            bad = [k for k, hit in misdirected.items() if hit]
            if bad:
                raise ValueError(
                    f"{bad} are device-backend knobs; the host backend "
                    "would silently ignore them — drop them or build "
                    "with backend='device'")
            return self._build_host(
                device=device, scheduler=scheduler, composer=composer,
                state_spec=state_spec, arg_spec=arg_spec,
                check_causality=check_causality,
                window_slack=window_slack, jit_handlers=jit_handlers,
                check=deferred_check)
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}; "
                             "expected 'device' or 'host'")
        if shard_fn is not None and shards is None:
            raise ValueError("shard_fn requires shards=N")
        if placement != "serial" and shards is None:
            raise ValueError(
                f"placement={placement!r} requires shards=N (it places "
                "the sharded engine's per-shard queues)")
        if shards is not None and queue_mode != "tiered3":
            raise ValueError(
                f"shards={shards} requires queue_mode='tiered3' (got "
                f"{queue_mode!r}): the per-shard pending sets are tiered3 "
                "queues")
        if isinstance(hot_words, str):
            if hot_words != "static":
                raise ValueError(
                    f"unknown hot_words spec {hot_words!r}; "
                    "expected 'static' or a sequence of words")
            if self._example_state is None:
                raise ValueError(
                    "hot_words='static' derives the hot set from the "
                    "static analyzer, which needs a state template — "
                    "declare one with prog.example_state(state) first")
            if report is None:
                report = self.analyze()
            hot_words = report.static_hot_words()
        if hot_words is not None:
            # Type names are the API-level spelling; the engine takes
            # ids.
            hot_words = [
                tuple(self.type_id(t) if isinstance(t, str) else int(t)
                      for t in word)
                for word in hot_words
            ]
        kw = dict(device=device, queue_mode=queue_mode, capacity=capacity,
                  front_cap=front_cap, stage_cap=stage_cap,
                  num_runs=num_runs, dispatch_mode=dispatch_mode,
                  hot_words=hot_words, validate=validate, overflow=overflow)
        if shards is not None:
            from repro_torch.core.sharded import ShardedDeviceEngine

            return CompiledSim(self, ShardedDeviceEngine.from_program(
                self, shards=shards, shard_fn=shard_fn, placement=placement,
                loop=loop, **kw), check=deferred_check)
        from repro_torch.core.engine import DeviceEngine

        return CompiledSim(self, DeviceEngine.from_program(self, loop=loop,
                                                           **kw),
                           check=deferred_check)

    def _build_host(self, *, device, scheduler, composer, state_spec,
                    arg_spec, check_causality, window_slack,
                    jit_handlers, check) -> "CompiledSim":
        from repro_torch.core.composer import EagerComposer, LazyComposer
        from repro_torch.core.engine import resolve_device
        from repro_torch.core.scheduler import (
            ConservativeScheduler,
            SpeculativeScheduler,
        )

        if scheduler not in _HOST_SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"expected one of {_HOST_SCHEDULERS}")
        device = resolve_device(device)
        if scheduler == "unbatched":
            return CompiledSim(self, backend="host", variant="unbatched",
                               jit_handlers=jit_handlers, device=device,
                               check=check)
        kw = dict(device=device, jit_handlers=jit_handlers)
        if composer == "lazy":
            comp = LazyComposer.from_program(self, **kw)
        elif composer == "eager":
            if arg_spec is None:
                arg_spec = ((ARG_WIDTH,), torch.float32)
            comp = EagerComposer.from_program(
                self, state_spec=state_spec, arg_spec=arg_spec, **kw)
        else:
            raise ValueError(f"unknown composer {composer!r}")
        if scheduler == "conservative":
            sched = ConservativeScheduler.from_program(
                self, composer=comp, check_causality=check_causality)
        else:
            sched = SpeculativeScheduler.from_program(
                self, composer=comp, window_slack=window_slack)
        return CompiledSim(self, backend="host", sched=sched,
                           variant=scheduler, jit_handlers=jit_handlers,
                           device=device, check=check)


class CompiledSim:
    """One (model, runtime) pairing with a uniform ``run`` contract:
    ``run`` is re-runnable, every call rebuilds the initial pending set
    from the program's schedule.  A device backend holds its ``engine``,
    a host backend its scheduler (``sched``; ``None`` for
    ``variant="unbatched"``), whose composed words stay compiled across
    runs."""

    def __init__(self, program: SimProgram, engine=None, *,
                 backend: str = "device", sched=None, variant: str = "",
                 jit_handlers: bool = True, device=None,
                 check: str = "off"):
        self.program = program
        self.engine = engine
        self.backend = backend
        self.sched = sched
        self.variant = variant
        self.jit_handlers = jit_handlers
        self.device = engine.device if engine is not None else device
        # Deferred build(check=...): no example state was declared, so
        # the analyzer runs against the first run()'s own initial state,
        # still before any event executes, then once only.
        self.check = check
        self._check_done = False

    def __repr__(self):
        return (f"CompiledSim({self.program.name!r}, "
                f"backend={self.backend!r}, variant={self.variant!r})")

    @property
    def registry(self) -> EventRegistry:
        return (self.program.device_registry() if self.backend == "device"
                else self.program.host_registry())

    def _initial_events(self, events):
        if events is None:
            return self.program.scheduled_events()
        evs = []
        for (t, ty, *rest) in events:
            type_id = (self.program.type_id(ty) if isinstance(ty, str)
                       else int(ty))
            evs.append((float(t), type_id,
                        normalize_arg(rest[0] if rest else None)))
        return evs

    # -- segmented device runs ---------------------------------------------
    def _rebalance_spill(self, queue, pool_rows, pool_seqs):
        """The pool outgrew the queue's room: merge queue and pool and
        keep the lex-smallest ``capacity`` events on the device; the rest
        stays in the pool.  Host O(capacity log capacity) at a segment
        boundary; the counters are kept, so the logical pending set is
        untouched, only its device/host split moves."""
        from repro_torch.core.queue import (
            tiered3_queue_from_columns,
            tiered3_queue_to_flat,
        )

        eng = self.engine
        flat = tiered3_queue_to_flat(queue)
        occ = flat.types >= 0
        times = np.concatenate([flat.times[occ], pool_rows[:, 0]])
        types = np.concatenate([flat.types[occ],
                                pool_rows[:, 1].astype(np.int32)])
        args = np.concatenate([flat.args[occ], pool_rows[:, 2:]])
        seqs = np.concatenate([flat.seqs[occ], pool_seqs])
        order = np.lexsort((seqs, times))
        C = eng.capacity
        keep, rest = order[:C], order[C:]
        q = tiered3_queue_from_columns(
            times[keep], types[keep], args[keep], seqs[keep], C,
            front_cap=eng.front_cap, stage_cap=eng.stage_cap,
            num_runs=eng.num_runs, device=eng.device)
        q = q._replace(next_seq=queue.next_seq.clone(),
                       dropped=queue.dropped.clone())
        new_rows = np.zeros((rest.size, EMIT_WIDTH), np.float32)
        new_rows[:, 0] = times[rest]
        new_rows[:, 1] = types[rest]
        new_rows[:, 2:] = args[rest]
        return q, new_rows, seqs[rest].astype(np.int32)

    def _set_fence(self, stats, key):
        """The stats with the engine's fence at ``key``, a host
        ``(time, seq)`` pair (``(inf, 2**31-1)``: no fence)."""
        dev = self.engine.device
        stats = dict(self.engine.initial_run_stats() if stats is None
                     else stats)
        stats["bound_t"] = torch.tensor(np.float32(key[0]), device=dev)
        stats["bound_seq"] = torch.tensor(np.int32(key[1]), device=dev)
        return stats

    @staticmethod
    def _pool_key(pool_rows, pool_seqs):
        """The lex-earliest ``(time, seq)`` key of the spill pool."""
        if not pool_seqs.size:
            return (float("inf"), I32_MAX)
        j = np.lexsort((pool_seqs, pool_rows[:, 0]))[0]
        return (float(pool_rows[j, 0]), int(pool_seqs[j]))

    def _absorb_spill(self, queue, pool_rows, pool_seqs, stats):
        """Reabsorb the spill pool, wholesale when it fits, else through
        the lex rebalance, and move the fence to the earliest key still
        outstanding.  Returns ``(queue, pool_rows, pool_seqs, stats)``."""
        eng = self.engine
        if pool_seqs.size:
            room = eng.capacity - host_read(eng.queue_occupancy(queue))
            if room >= int(pool_seqs.size):
                COUNTS["absorb"] += 1
                queue = eng.absorb_rows(
                    queue, torch.from_numpy(pool_rows).to(eng.device),
                    torch.from_numpy(pool_seqs).to(eng.device))
                pool_rows = np.zeros((0, EMIT_WIDTH), np.float32)
                pool_seqs = np.zeros((0,), np.int32)
            else:
                COUNTS["rebalance"] += 1
                queue, pool_rows, pool_seqs = self._rebalance_spill(
                    queue, pool_rows, pool_seqs)
        stats = self._set_fence(stats, self._pool_key(pool_rows, pool_seqs))
        return queue, pool_rows, pool_seqs, stats

    def _absorb_block(self, queue, rows, seqs, lo: int, hi: int):
        """Absorb rows ``[lo, hi)`` of a staged arrival block (the masked
        absorb of JAX's ``_absorb_fn``)."""
        COUNTS["absorb"] += 1
        idx = torch.arange(rows.shape[0], device=rows.device)
        return self.engine.absorb_rows(queue, rows, seqs,
                                       (idx >= lo) & (idx < hi))

    def _queue_next_time(self, queue) -> float:
        """Earliest pending time (a host float), single or sharded: one
        host read either way."""
        return float(host_read(self.engine.queue_next_time(queue)))

    @staticmethod
    def _save_checkpoint(manager, step, state, queue, stats,
                         pool_rows, pool_seqs, *, extra=None, strip=()):
        # "dropped" lives on the queue, not in the carry; fence-only
        # streamed runs also strip the host-set bound (recomputed from
        # the restored cursor at the first resumed boundary).
        drop = {"dropped", *strip}
        payload = {
            "state": state,
            "queue": queue,
            "stats": {k: v for k, v in stats.items() if k not in drop},
            "pool_rows": np.asarray(pool_rows),
            "pool_seqs": np.asarray(pool_seqs),
        }
        if extra:
            payload.update(extra)
        manager.save_async(step, payload)

    def _run_device(self, state, evs, t_end, total_batches, *,
                    checkpoint_every, checkpoint_dir, resume_from,
                    segment_hook, arrivals=None, backpressure="block",
                    stream_prefetch=True):
        eng = self.engine
        spill = eng.overflow == "spill"
        streamed = arrivals is not None
        if streamed and eng.queue_mode != "tiered3":
            raise ValueError(
                "run(arrivals=...) on the device backend requires "
                f"queue_mode='tiered3', got {eng.queue_mode!r}: the "
                "admission fence is a tiered3 lex bound")
        if (checkpoint_every is not None or resume_from is not None) \
                and checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every/resume_from require checkpoint_dir=")
        seg = None if checkpoint_every is None else int(checkpoint_every)
        if seg is not None and seg < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {seg}")
        manager = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            manager = CheckpointManager(checkpoint_dir)

        if spill:
            queue, pool_rows, pool_seqs = eng.initial_queue_spill(evs)
        else:
            queue = eng.initial_queue(evs)
            pool_rows = np.zeros((0, EMIT_WIDTH), np.float32)
            pool_seqs = np.zeros((0,), np.int32)
        stats = None
        cursor, ingested, shed = 0, 0, 0
        if streamed:
            # Reserve the arrival seq range upfront: arrival j carries
            # seq len(evs) + j and mid-run emits draw seqs past the
            # reservation, so an absorbed arrival takes exactly the
            # (time, seq) rank it would have had pre-seeded.
            queue = queue._replace(next_seq=queue.next_seq + len(arrivals))

        if resume_from is not None:
            step = None if resume_from == "latest" else int(resume_from)
            restored, at_step = manager.restore({
                "state": state,
                "queue": queue,
                "stats": eng.initial_run_stats(),
            }, step)
            state, queue = restored["state"], restored["queue"]
            # Restored leaves are whole; a placed engine (sharded
            # placement="devices") re-places them, each rank its shard.
            queue = eng.place_queue(queue)
            stats = restored["stats"]
            pool_rows = np.asarray(
                manager.restore_leaf("pool_rows", at_step), np.float32)
            pool_seqs = np.asarray(
                manager.restore_leaf("pool_seqs", at_step), np.int32)
            saved_cursor = manager.restore_leaf(
                "ingest_cursor", at_step, default=None)
            if saved_cursor is not None and not streamed:
                raise ValueError(
                    "checkpoint was written by a streamed run "
                    f"(arrival cursor {int(saved_cursor)}): resume with "
                    "the same arrivals= source")
            if streamed and saved_cursor is not None:
                cursor = int(saved_cursor)
                ingested = int(manager.restore_leaf(
                    "ingested", at_step, default=np.int64(0)))
                shed = int(manager.restore_leaf(
                    "shed", at_step, default=np.int64(0)))

        feeder = None
        if streamed:
            from repro_torch.stream.ingest import StreamFeeder
            feeder = StreamFeeder(arrivals, len(evs), start=cursor,
                                  prefetch=stream_prefetch,
                                  device=eng.device)
        try:
            (state, queue, stats, pool_rows, pool_seqs,
             ingested, shed) = self._segment_loop(
                state, queue, stats, pool_rows, pool_seqs,
                t_end=t_end, total_batches=total_batches, seg=seg,
                spill=spill, manager=manager, segment_hook=segment_hook,
                feeder=feeder, backpressure=backpressure,
                ingested=ingested, shed=shed)
        finally:
            if feeder is not None:
                feeder.close()
            if manager is not None:
                # Even on a fault path, drain the writer so the newest
                # checkpoint on disk is complete.
                manager.wait()

        word_counts = stats.get("word_counts")
        raw = dict(stats)
        raw["final_queue"] = queue
        return RunResult(
            state=state,
            events=int(stats["events"]),
            batches=int(stats["batches"]),
            dropped=int(stats["dropped"]),
            final_time=float(stats["time"]),
            raw=raw,
            word_counts=(None if word_counts is None
                         else word_counts.cpu().numpy()),
            emitted=int(stats["emitted"]),
            pending=int(eng.queue_occupancy(queue)),
            spilled=int(pool_seqs.size),
            fault_word=int(stats.get("fault_word", 0)),
            ingested=int(ingested),
            shed=int(shed),
        )

    def _segment_loop(self, state, queue, stats, pool_rows, pool_seqs, *,
                      t_end, total_batches, seg, spill, manager,
                      segment_hook, feeder=None, backpressure="block",
                      ingested=0, shed=0):
        from repro_torch.core.validate import (
            FAULT_INGEST,
            FAULT_SPILL_STALL,
            EngineFaultError,
        )

        eng = self.engine
        streamed = feeder is not None
        seg_index = 0
        idle_rounds = 0
        while True:
            progressed = False
            if spill and pool_seqs.size:
                queue, pool_rows, pool_seqs, stats = \
                    self._absorb_spill(queue, pool_rows, pool_seqs, stats)
            # Streamed admission: at most one arrival block a boundary,
            # so the admitted / spilled / shed split is a function of
            # the cursor, the horizon and the occupancy alone, never of
            # the feeder's timing.
            if streamed and feeder.has_pending():
                # Arrivals past the horizon are never consumed.
                adm = feeder.admissible(t_end)
                if adm:
                    occ = host_read(eng.queue_occupancy(queue))
                    k = min(adm, max(eng.capacity - occ, 0))
                    if k > 0:
                        rows_d, seqs_d, lo = feeder.device_block()
                        queue = self._absorb_block(queue, rows_d, seqs_d,
                                                   lo, lo + k)
                        feeder.advance(k)
                        ingested += k
                        progressed = True
                    rest = adm - k
                    if rest > 0:
                        if spill:
                            r_rows, r_seqs = feeder.host_slice(rest)
                            pool_rows = np.concatenate([pool_rows, r_rows])
                            pool_seqs = np.concatenate([pool_seqs, r_seqs])
                            feeder.advance(rest)
                            ingested += rest
                            progressed = True
                        elif backpressure == "shed":
                            feeder.advance(rest)
                            ingested += rest
                            shed += rest
                            progressed = True
                        elif backpressure == "error":
                            raise EngineFaultError(
                                FAULT_INGEST,
                                0 if stats is None else stats["batches"],
                                detail=(
                                    f"{rest} arrival(s) found the "
                                    f"capacity-{eng.capacity} queue "
                                    "full (backpressure='error')"))
                        # backpressure='block': the rows wait in the
                        # feeder; the fence keeps the order, and the
                        # stall detector below turns a wedge into
                        # FAULT_INGEST.
            if streamed:
                # The admission fence: the lex-earliest outstanding
                # external key, the next arrival or the pool's head.
                key = min(feeder.next_key(),
                          self._pool_key(pool_rows, pool_seqs) if spill
                          else (float("inf"), I32_MAX))
                stats = self._set_fence(stats, key)
            done = 0 if stats is None else stats["batches"]
            target = (total_batches if seg is None
                      else min(total_batches, done + seg))
            state, queue, stats = eng.run(
                state, queue, max_batches=target, t_end=t_end, stats=stats)
            new_done = stats["batches"]
            if new_done > done:
                progressed = True
            if spill:
                n = host_read(stats["spill_n"])
                if n > 0:
                    pool_rows = np.concatenate(
                        [pool_rows, stats["spill_rows"][:n].cpu().numpy()])
                    pool_seqs = np.concatenate(
                        [pool_seqs, stats["spill_seqs"][:n].cpu().numpy()])
                    stats = dict(stats)
                    stats["spill_n"] = torch.zeros_like(stats["spill_n"])
            seg_index += 1
            # Save BEFORE the injection seam: the newest checkpoint is
            # always a clean pre-corruption snapshot.
            if manager is not None and seg is not None:
                self._save_checkpoint(
                    manager, new_done, state, queue, stats,
                    pool_rows, pool_seqs,
                    extra=(dict(
                        ingest_cursor=np.int64(feeder.cursor),
                        ingested=np.int64(ingested),
                        shed=np.int64(shed),
                    ) if streamed else None),
                    strip=(("bound_t", "bound_seq")
                           if streamed and not spill else ()))
            if segment_hook is not None:
                out = segment_hook(seg_index, state, queue, stats)
                if out is not None:
                    state, queue, stats = out
            if new_done >= total_batches:
                break
            pool_live = bool(spill and pool_seqs.size)
            feeder_live = streamed and feeder.has_pending()
            if pool_live or feeder_live:
                qt = self._queue_next_time(queue)
                pool_t = (float(pool_rows[:, 0].min()) if pool_live
                          else float("inf"))
                feed_t = (feeder.next_time() if feeder_live
                          else float("inf"))
                if qt > t_end and pool_t > t_end and feed_t > t_end:
                    # Everything outstanding is past the horizon.
                    break
                if not progressed:
                    idle_rounds += 1
                    # One idle round is legal (the absorb or rebalance
                    # runs next round); repeated idleness means the
                    # fence can never clear.
                    if idle_rounds >= 3:
                        word = (FAULT_INGEST if feeder_live
                                else FAULT_SPILL_STALL)
                        n_out = (int(pool_seqs.size) if pool_live
                                 else feeder.n - feeder.cursor)
                        raise EngineFaultError(
                            word, new_done,
                            detail=(f"{n_out} external event(s) "
                                    "outstanding but no segment can "
                                    "make progress"))
                else:
                    idle_rounds = 0
                continue
            if new_done < target:
                # The loop stopped before its target: drained, horizon,
                # or fence with nothing outstanding, all terminal.
                break
        return state, queue, stats, pool_rows, pool_seqs, ingested, shed

    # -- host runs ----------------------------------------------------------
    def _run_host(self, state, evs, t_end, *, max_batches, max_events,
                  arrivals, backpressure, device_knobs) -> RunResult:
        if device_knobs:
            raise ValueError(
                "checkpoint_every/checkpoint_dir/resume_from are "
                "device-backend knobs; the host backend would silently "
                "ignore them — drop them or build with backend='device'")
        if arrivals is not None and backpressure != "block":
            raise ValueError(
                "host backends push the stream into an unbounded heap: "
                "backpressure='shed'/'error' can never trigger there — "
                "use the default 'block' or build backend='device'")
        queue = HostEventQueue()
        queue.push_all(evs)
        n_ingested = 0
        if arrivals is not None:
            # Seeds first (seqs 0..n0-1), then the stream in source
            # order: the device's seq reservation, so the heap's (time,
            # seq) order is the closed pre-seeded run's.
            arrivals.seek(0)
            rows = [row for block in arrivals.blocks()
                    for row in np.asarray(block, np.float32) if row[1] >= 0]
            queue.push_all((float(row[0]), int(row[1]),
                            normalize_arg(row[2:])) for row in rows)
            n_ingested = len(rows)
        state, rs = self._schedule(state, queue, max_events=max_events,
                                   max_batches=max_batches, t_end=t_end)
        return RunResult(
            state=state,
            events=rs.events_executed,
            batches=rs.batches_executed,
            dropped=0,
            final_time=float(rs.final_time),
            rollbacks=rs.rollbacks,
            raw=rs,
            ingested=n_ingested,
        )

    def _schedule(self, state, queue, *, max_events, max_batches, t_end):
        """The host scheduler's run over the built heap: ``(state,
        RunStats)``."""
        if self.variant == "unbatched":
            from repro_torch.core.scheduler import run_unbatched

            return run_unbatched(
                self.program.host_registry(), state, queue,
                jit_handlers=self.jit_handlers, max_events=max_events,
                max_batches=max_batches, t_end=t_end, device=self.device)
        return self.sched.run(state, queue, max_events=max_events,
                              max_batches=max_batches, t_end=t_end)

    def run(self, state, *, until: float | None = None,
            max_batches: int | None = None, max_events: int | None = None,
            events: Sequence | None = None, arrivals=None,
            backpressure: str = "block",
            checkpoint_every: int | None = None,
            checkpoint_dir: str | None = None,
            resume_from: int | str | None = None,
            _segment_hook: Callable | None = None,
            _stream_prefetch: bool = True) -> RunResult:
        """Execute until the pending set drains or a bound trips:
        ``until`` stops before any event later than it runs,
        ``max_batches`` bounds executed super-steps, ``events``
        replaces the program's initial schedule for this run.

        ``arrivals`` opens the system: a
        :class:`repro_torch.stream.ArrivalSource` streamed into the run
        in fixed blocks, absorbed at segment boundaries under the lex
        admission fence; the result is bit-identical to pre-seeding the
        same trace as long as neither run overflows, and arrivals past
        ``until`` are never consumed.  ``backpressure`` picks what an
        admissible arrival that finds the queue full does: ``"block"``
        (wait; a wedged topology raises ``FAULT_INGEST``), ``"shed"``
        (drop it, counted in ``RunResult.shed``) or ``"error"`` (raise);
        with ``overflow="spill"`` it joins the spill pool instead.

        ``checkpoint_every=N`` snapshots the whole carry to
        ``checkpoint_dir`` every ``N`` super-steps (asynchronously,
        atomically), and ``resume_from=step`` (or ``"latest"``) restores
        one and continues; a resumed run is bit-identical to an
        uninterrupted one.  ``_segment_hook(seg_index, state, queue,
        stats)`` is the fault-injection seam between segments: it may
        return a replacement ``(state, queue, stats)`` (tests only).
        """
        t_end = float("inf") if until is None else float(until)
        if backpressure not in ("block", "shed", "error"):
            raise ValueError(
                f"backpressure must be 'block', 'shed' or 'error', "
                f"got {backpressure!r}")
        if arrivals is None and backpressure != "block":
            raise ValueError(
                "backpressure= configures streamed runs — pass "
                "arrivals= as well")
        evs = self._initial_events(events)
        if self.check != "off" and not self._check_done:
            self.program._run_check(self.check, state=state)
            self._check_done = True
        if self.backend == "host":
            return self._run_host(
                state, evs, t_end,
                max_batches=max_batches, max_events=max_events,
                arrivals=arrivals, backpressure=backpressure,
                device_knobs=(checkpoint_every is not None
                              or checkpoint_dir is not None
                              or resume_from is not None
                              or _segment_hook is not None))
        if max_events is not None:
            raise ValueError("max_events is host-only; the device loop "
                             "counts batches — use max_batches")
        return self._run_device(
            state, evs, t_end,
            (1 << 30) if max_batches is None else int(max_batches),
            checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, resume_from=resume_from,
            segment_hook=_segment_hook, arrivals=arrivals,
            backpressure=backpressure, stream_prefetch=_stream_prefetch)
