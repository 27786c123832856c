"""The on-device simulation engine (PyTorch port).

Counterpart of :class:`repro.core.engine.DeviceEngine` for
``queue_mode="tiered3"``, ``dispatch_mode`` in ``{"switch", "masked",
"fused"}``, ``overflow="drop"`` and ``validate="off"``, with the
entity-parallel run path; any other mode raises
:class:`NotImplementedError`.

JAX compiles the whole run into one ``lax.while_loop``.  Here the loop
is a Python loop over eager super-steps, each of which:

1. reads the loop guard (pending events, ``next_time <= t_end``) to the
   host;
2. extracts the §III-B window (:func:`tiered3_queue_extract`: the
   bounded refill, then the ``window_extract`` kernel);
3. reads the window's types and length to the host once and runs, as
   straight-line eager code, the vmapped run handler when the window
   is a run of one entity-parallel type, else the composed branch
   (``switch``), the per-lane legs (``masked``) or the hot word's
   branch or the masked fallback (``fused``, chosen by the host-side
   word code);
4. inserts the emitted rows (:func:`tiered3_queue_fill_rows`: the
   pre-flush check, then the ``front_merge`` kernel).

So a common super-step costs four device-to-host reads (the guard, the
refill check, the window, the pre-flush check), counted with the
queue's rare-path reads in ``repro_torch.core.queue.COUNTS``, which
also counts the windows that took the run path (``run_path``), a hot
slot (``fused_hot``) and the fallback (``fused_fallback``).  The stats
carry (``batches``, ``events``, ``emitted``, ``time``,
``word_counts``) matches the JAX engine's field for field.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.codec import DenseCodec
from repro_torch.core.composer import (
    build_fused_dispatcher,
    build_masked_dispatcher,
    build_switch_dispatcher,
)
from repro_torch.core.events import EventRegistry
from repro_torch.core.queue import (
    COUNTS,
    _f32,
    host_list,
    host_read,
    tiered3_queue_extract,
    tiered3_queue_fill_rows,
    tiered3_queue_from_host,
    tiered3_queue_has_pending,
    tiered3_queue_next_time,
    tiered3_queue_occupancy,
)
from repro_torch.core.tree import tree_map
from repro_torch.core.vectorize import make_masked_run_handler

# The fused mode's hot-set width when no hot_words are given (the first
# W dense codes), and the word count beyond which the per-word
# histogram is not carried (the JAX engine's values).
_DEFAULT_HOT_W = 32
_WORD_COUNT_LIMIT = 4096

_UNPORTED = {
    "queue_mode": ("tiered", "flat", "reference"),
    "dispatch_mode": (),
    "validate": ("cheap", "full"),
    "overflow": ("error", "spill"),
}
_PORTED = {
    "queue_mode": ("tiered3",),
    "dispatch_mode": ("switch", "masked", "fused"),
    "validate": ("off",),
    "overflow": ("drop",),
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
    to avoid copying its per-LP counters once per event).
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

    def __post_init__(self):
        self.registry.freeze()
        for knob, ported in _PORTED.items():
            value = getattr(self, knob)
            if value in _UNPORTED[knob]:
                raise NotImplementedError(
                    f"{knob}={value!r} is not ported to repro_torch yet; "
                    f"ported: {ported}")
            if value not in ported:
                raise ValueError(f"unknown {knob} {value!r}")
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
                     overflow: str = "drop") -> "DeviceEngine":
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
        )

    def initial_queue(self, events):
        """The seed queue, built on the host and copied once."""
        return tiered3_queue_from_host(
            events, self.capacity, front_cap=self.front_cap,
            stage_cap=self.stage_cap, num_runs=self.num_runs,
            device=self.device)

    def queue_occupancy(self, queue) -> torch.Tensor:
        return tiered3_queue_occupancy(queue)

    def initial_run_stats(self) -> dict:
        """The stats carry: host ints for the counters the host already
        knows, device tensors for the rest."""
        stats = {
            "batches": 0,
            "events": 0,
            "emitted": torch.zeros((), dtype=torch.int32, device=self.device),
            "time": torch.zeros((), dtype=torch.float32, device=self.device),
        }
        if self._track_word_counts:
            stats["word_counts"] = torch.zeros(
                (self.codec.num_batches,), dtype=torch.int32,
                device=self.device)
        return stats

    def _dispatch_window(self, state, ts, args, types, length, code):
        """Dispatch one window (host ``types``, ``length`` and ``code``);
        returns (state, emits).  Every route runs the same handler
        sequence, so the choice never changes a result."""
        run = self._run_branches.get(types[0]) if length else None
        if run is not None and all(ty == types[0]
                                   for ty in types[1:length]):
            COUNTS["run_path"] += 1
            state = run(state, ts, args, args[:, 0].to(torch.int32),
                        self._lanes < length)
            return state, self.dispatch.empty_emits(ts.device)
        if self.dispatch_mode == "masked":
            return self._dispatch_masked(state, ts, types, args, length)
        if self.dispatch_mode == "fused":
            return self._dispatch_fused(code, state, ts, types, args,
                                        length)
        return self.dispatch(code, state, ts, args)

    def run(self, state, queue, *, max_batches: int = 1 << 30,
            t_end: float = float("inf")):
        """Run until the pending set drains, ``max_batches`` super-steps
        have run, or the next event lies past ``t_end`` (the window is
        capped at ``t_end``, so exactly the events at or before it
        execute).  Returns ``(state, queue, stats)``."""
        t_end = _f32(t_end)
        state = tree_map(lambda x: x.to(self.device, copy=True), state)
        stats = self.initial_run_stats()
        k = self.max_batch_len
        while stats["batches"] < max_batches:
            ok = tiered3_queue_has_pending(queue) & (
                tiered3_queue_next_time(queue) <= t_end)
            if not host_read(ok):
                break
            queue, ts, tys, args, length = tiered3_queue_extract(
                queue, k, self._lookaheads, t_end)
            window = host_list(torch.cat([tys, length.reshape(1)]))
            n = window[-1]
            # encode_jnp gives code 0 for an empty window.
            code = self.codec.encode(window[:n]) if n else 0
            state, emits = self._dispatch_window(
                state, ts, args, window[:k], n, code)
            queue = tiered3_queue_fill_rows(queue, emits)
            stats["batches"] += 1
            stats["events"] += n
            stats["emitted"] = stats["emitted"] + torch.sum(
                emits[:, 1] >= 0).to(torch.int32)
            stats["time"] = torch.maximum(stats["time"], ts[max(n - 1, 0)])
            if self._track_word_counts:
                stats["word_counts"][code] += 1
        stats["dropped"] = queue.dropped
        return state, queue, stats
