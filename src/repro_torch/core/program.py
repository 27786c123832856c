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

``SimProgram.host_registry()`` gives the host runtimes' registry for
handlers that emit nothing — what the serving control plane needs.
Not ported yet: emitting host handlers and the host backend, the static
analyzer (and so ``hot_words="static"``), checkpoint / resume, streamed
arrivals and the spill policy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.events import ARG_WIDTH, EventRegistry
from repro_torch.core.tree import tree_map

EMIT_WIDTH = 2 + ARG_WIDTH


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
        eid = arg[0].to(torch.int64).reshape(1)
        sub = tree_map(lambda leaf: leaf.index_select(0, eid)[0], state)
        out = local(sub, t, arg)
        return tree_map(
            lambda leaf, new: leaf.index_copy_(
                0, eid, new.to(leaf.dtype).unsqueeze(0)),
            state, out)

    handler.__name__ = f"entity_seq_{name}"
    return handler


@dataclasses.dataclass(frozen=True)
class RunResult:
    """Normalized result of one :meth:`CompiledSim.run`: the JAX
    ``RunResult``'s fields for a closed device run (the host-only,
    fault and stream fields come with those features)."""

    state: Any
    events: int
    batches: int
    dropped: int
    final_time: float
    raw: Any = None
    word_counts: Any = None
    emitted: int = 0
    pending: int = 0

    @property
    def mean_batch_length(self) -> float:
        return self.events / self.batches if self.batches else 0.0


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

    def scheduled_events(self) -> list[tuple[float, int, np.ndarray]]:
        return list(self._schedule)

    def example_state(self, state) -> "SimProgram":
        """Declare a representative initial state (shapes and dtypes
        only), as :meth:`repro.core.program.SimProgram.example_state`
        does; the static analyzer that reads it is not ported yet."""
        self._example_state = state
        return self

    def freeze(self) -> "SimProgram":
        self._frozen = True
        return self

    def type_id(self, name: str) -> int:
        return self._by_name[name].type_id

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
        """Registry for the host runtimes, for handlers that emit
        nothing (they take and return the state as they are given it:
        plain Python objects, bound methods included).  Emitting
        handlers raise :class:`NotImplementedError`."""
        self.freeze()
        if self._host_registry is None:
            reg = EventRegistry()
            for spec in self._specs:
                if spec.emits:
                    raise NotImplementedError(
                        f"handler {spec.name!r} emits events; emitting "
                        "host handlers are not ported to repro_torch yet")
                fn = spec.fn
                if spec.entity:
                    fn = _sequential_from_entity(fn, spec.name)
                reg.register(spec.name, fn, lookahead=spec.lookahead)
            self._host_registry = reg.freeze()
        return self._host_registry

    def device_entity_handlers(self) -> dict[int, Callable]:
        """type_id -> entity-local handler, for the device engine's
        vmapped single-type-run dispatch."""
        return {s.type_id: s.fn for s in self._specs if s.entity}

    def build(self, *, backend: str = "device", device=None,
              queue_mode: str = "tiered3", capacity: int | None = None,
              front_cap: int | None = None, stage_cap: int | None = None,
              num_runs: int | None = None, dispatch_mode: str = "switch",
              hot_words=None, validate: str = "off",
              overflow: str = "drop") -> "CompiledSim":
        """Compile this model for the device backend.

        ``device=None`` runs on the CUDA card and raises when there is
        none; ``device="cpu"`` runs the same code on the CPU, with the
        kernels' plain versions.  ``hot_words`` (``dispatch_mode=
        "fused"`` only) is a sequence of words, each a sequence of type
        names or ids.  Modes the port does not have yet raise
        :class:`NotImplementedError`.
        """
        self.freeze()
        if backend == "host":
            raise NotImplementedError(
                "the host backend is not ported to repro_torch yet")
        if backend != "device":
            raise ValueError(f"unknown backend {backend!r}")
        if isinstance(hot_words, str):
            if hot_words != "static":
                raise ValueError(
                    f"unknown hot_words spec {hot_words!r}; "
                    "expected 'static' or a sequence of words")
            raise NotImplementedError(
                "hot_words='static' takes the hot set from the static "
                "analyzer, which is not ported to repro_torch yet "
                "(ROADMAP A12); pass the words, e.g. from "
                "hot_words_from_counts over a profiled run")
        if hot_words is not None:
            # Type names are the API-level spelling; the engine takes
            # ids.
            hot_words = [
                tuple(self.type_id(t) if isinstance(t, str) else int(t)
                      for t in word)
                for word in hot_words
            ]
        from repro_torch.core.engine import DeviceEngine

        engine = DeviceEngine.from_program(
            self, device=device, queue_mode=queue_mode, capacity=capacity,
            front_cap=front_cap, stage_cap=stage_cap, num_runs=num_runs,
            dispatch_mode=dispatch_mode, hot_words=hot_words,
            validate=validate, overflow=overflow)
        return CompiledSim(self, engine)


class CompiledSim:
    """One (model, device engine) pairing; ``run`` is re-runnable: every
    call rebuilds the initial pending set from the program's schedule."""

    def __init__(self, program: SimProgram, engine):
        self.program = program
        self.engine = engine

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

    def run(self, state, *, until: float | None = None,
            max_batches: int | None = None, max_events: int | None = None,
            events=None) -> RunResult:
        """Execute until the pending set drains or a bound trips:
        ``until`` stops before any event later than it runs,
        ``max_batches`` bounds executed super-steps, ``events``
        replaces the program's initial schedule for this run."""
        if max_events is not None:
            raise ValueError("max_events is host-only; the device loop "
                             "counts batches — use max_batches")
        eng = self.engine
        queue = eng.initial_queue(self._initial_events(events))
        state, queue, stats = eng.run(
            state, queue,
            max_batches=(1 << 30) if max_batches is None else int(max_batches),
            t_end=float("inf") if until is None else float(until))
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
        )
