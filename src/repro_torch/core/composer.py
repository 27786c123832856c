"""Batch composition (paper §III-A, Alg. 1), PyTorch port.

Counterpart of :mod:`repro.core.composer`.  A batch word ``w = [t0,
t1, ...]`` becomes one straight-line program that applies the handlers
back to back.

**Host composers** (the paper's runtime, driven by the schedulers of
:mod:`repro_torch.core.scheduler`): :func:`compose_word_fn` concatenates
a word's handlers into one function, and the composers hand it to
``torch.compile(fullgraph=True)`` — the counterpart of JAX's
``jax.jit`` of the same word, so Inductor sees the word's handlers as
one procedure, as XLA does in the JAX package and clang in the paper.

* :class:`EagerComposer` composes and compiles every code up front and
  warms each compiled word once on zero tensors shaped like
  ``state_spec``/``arg_spec``.
* :class:`LazyComposer` composes a word on its first dispatch and
  compiles it there (§IV.D).

``jit_handlers=False`` runs the composed words eagerly (the parity
spec, and the CPU tests' route).  A word that cannot be one graph
fails and names the word: it is never split, and a failed compile
never falls back to eager.  Each word gets a code object of its own,
so Dynamo's per-code cache holds one entry a word.

**Device dispatchers** (the on-device engine): JAX selects the branch
on the device with ``lax.switch``.  The engine's eager loop reads the
window's types and length to the host once per super-step and the
dispatcher runs the selected Python code:

* :func:`build_switch_dispatcher` — one composed branch per dense
  codec word, indexed by the host-side word code;
* :func:`build_masked_dispatcher` — one handler leg per window lane,
  selected by the lane's type, no-op past ``length``;
* :func:`build_fused_dispatcher` — the two-level composition of
  DESIGN.md §7: the hot words' composed branches, and the masked path
  for every other word.

All three run the identical handler sequence with the identical emit
layout, so they are bit-identical to each other and to the JAX modes of
the same names.

Each dispatcher's ``on_device`` makes the same choice from device
tensors (the word code, the types, the length), as JAX's
``_dispatch_window`` does: ``switch`` one
:func:`~repro_torch.core.capture.select` over the words, ``masked`` one
a lane over the types (none past ``length``), ``fused`` one over the
hot slots and the fallback, the slot gathered from a device copy of
``hot_slot_table``.  The engine's captured loop runs these; captured in
a CUDA graph each ``select`` is a SWITCH node, so the step reads
nothing.  The branches still run the same aten calls as the eager
ones: nothing compiles across a word's handlers on the device backend,
so there the paper's cross-event scope is not recovered until the
branches inside the graph are compiled (ROADMAP A5).
"""

from __future__ import annotations

import functools
import time as _time
import types as _types
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.capture import bump, call_handler, select
from repro_torch.core.codec import DenseCodec, make_codec
from repro_torch.core.events import (
    ARG_WIDTH,
    EventRegistry,
    normalize_handler_result,
)
from repro_torch.core.program import normalize_arg


# ---------------------------------------------------------------------------
# Host-side batch programs
# ---------------------------------------------------------------------------

def named_function(fn: Callable, name: str) -> Callable:
    """``fn`` under a code object of its own named ``name``.  Dynamo
    caches compiled frames per code object, so closures of one function
    (every composed word, every adapted handler) would otherwise share
    one cache and hit its recompile limit."""
    code = fn.__code__.replace(co_name=name, co_qualname=name)
    out = _types.FunctionType(code, fn.__globals__, name, fn.__defaults__,
                              fn.__closure__)
    out.__wrapped__ = fn
    return out


def compile_fn(fn: Callable, name: str) -> Callable:
    """``torch.compile(fn, fullgraph=True)`` with no fallback: a frame
    that cannot be one graph raises a :class:`RuntimeError` naming
    ``name`` instead of splitting, and Dynamo's ``suppress_errors``
    (which would run a failed frame eagerly) is refused."""
    import torch._dynamo

    if torch._dynamo.config.suppress_errors:
        raise RuntimeError(
            "torch._dynamo.config.suppress_errors is set: a failed compile "
            f"of {name} would run eagerly; unset it")
    compiled = torch.compile(fn, fullgraph=True)

    @functools.wraps(fn)
    def call(*args):
        t0 = _time.perf_counter()
        try:
            out = compiled(*args)
        except Exception as err:
            if type(err).__module__.startswith(("torch._dynamo",
                                                "torch._inductor")):
                raise RuntimeError(
                    f"{name} did not compile as one graph "
                    f"({type(err).__name__})") from err
            raise
        if call.first_call_s is None:
            call.first_call_s = _time.perf_counter() - t0
        return out

    # Seconds of the first call, which compiles (None until then).
    call.first_call_s = None
    return call


def compose_word_fn(registry: EventRegistry, word: Sequence[int]) -> Callable:
    """Concatenate the handlers of ``word`` into one function.

    Returns ``fn(state, ts, args) -> (state, emitted)`` with ``ts`` the
    word's timestamps (f32[k]) and ``args`` its arguments
    (f32[k, ARG_WIDTH]); ``emitted`` is the list of events created by
    any handler, in execution order (deferred scheduling, §IV.D), as
    ``(src, delay, type_id, arg)`` tuples where ``src`` is the index in
    the batch of the emitting event: schedulers anchor the new event at
    that event's timestamp plus ``delay``.
    """
    ets = [registry[t] for t in word]

    def batch_fn(state, ts, args):
        emitted = []
        for i, et in enumerate(ets):
            result = et.handler(state, ts[i], args[i])
            state, new = normalize_handler_result(
                result, returns_events=et.returns_events)
            emitted.extend((i, delay, ty, a) for (delay, ty, a) in new)
        return state, emitted

    return named_function(batch_fn,
                          "batch_" + "_".join(et.name for et in ets))


def _spec_zeros(spec, device):
    """Zeros shaped like ``spec``: an example tensor, a ``(shape,
    dtype)`` pair, or a dict / list / tuple of these."""
    if torch.is_tensor(spec):
        return torch.zeros_like(spec, device=device)
    if (isinstance(spec, tuple) and len(spec) == 2
            and isinstance(spec[1], torch.dtype)):
        return torch.zeros(tuple(spec[0]), dtype=spec[1], device=device)
    if isinstance(spec, dict):
        return type(spec)((k, _spec_zeros(v, device))
                          for k, v in spec.items())
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return type(spec)(*(_spec_zeros(v, device) for v in spec))
    if isinstance(spec, (list, tuple)):
        return type(spec)(_spec_zeros(v, device) for v in spec)
    raise TypeError(f"not a state spec leaf: {spec!r}")


def batch_inputs(times: Sequence[float], args: Sequence, device):
    """A batch's handler inputs in one host-to-device copy: ``ts``
    (f32[k], the event times rounded to f32) and ``args`` (f32[k,
    ARG_WIDTH], each argument normalized to the fixed record), views of
    one ``[k, 1 + ARG_WIDTH]`` block.  Every batch of a word has this
    one layout, so a compiled word is traced once."""
    block = np.empty((len(times), 1 + ARG_WIDTH), np.float32)
    block[:, 0] = times
    for i, a in enumerate(args):
        block[i, 1:] = (a if isinstance(a, np.ndarray)
                        and a.shape == (ARG_WIDTH,) else normalize_arg(a))
    block = torch.from_numpy(block).to(device)
    return block[:, 0], block[:, 1:]


class _ComposerBase:
    """Shared bookkeeping for host-side composers.

    ``device`` is where the words run (``None``: the CUDA card, which
    must be present); ``jit_handlers`` picks the compile route
    (``torch.compile`` a word) or the eager one."""

    def __init__(self, registry: EventRegistry, codec, *, device=None,
                 jit_handlers: bool = True):
        from repro_torch.core.engine import resolve_device

        registry.freeze()
        self.registry = registry
        self.codec = codec
        self.device = resolve_device(device)
        self.jit_handlers = jit_handlers
        self._programs: dict[int, Callable] = {}
        self._words: dict[int, tuple[int, ...]] = {}
        self._build_seconds: dict[int, float] = {}
        self.trace_count = 0
        # Per-word execution histogram (code -> dispatch count), the
        # host-side profiling source for hot-word selection.
        self.execute_counts: dict[int, int] = {}

    @property
    def compile_seconds(self) -> dict[int, float]:
        """code -> seconds of composing the word and, on the compile
        route, of its first call, which compiles it."""
        return {code: s + (getattr(self._programs.get(code),
                                   "first_call_s", None) or 0.0)
                for code, s in self._build_seconds.items()}

    def word_for(self, code: int) -> tuple[int, ...]:
        if code not in self._words:
            self._words[code] = tuple(self.codec.decode(code))
        return self._words[code]

    def _build(self, code: int) -> Callable:
        fn = compose_word_fn(self.registry, self.word_for(code))
        self.trace_count += 1
        return compile_fn(fn, fn.__name__) if self.jit_handlers else fn

    def program(self, code: int) -> Callable:
        if code not in self._programs:
            t0 = _time.perf_counter()
            self._programs[code] = self._build(code)
            self._build_seconds[code] = _time.perf_counter() - t0
        return self._programs[code]

    def execute(self, code: int, state, ts, args):
        """Run batch ``code``; returns ``(state, emitted_events)``."""
        self.execute_counts[code] = self.execute_counts.get(code, 0) + 1
        return self.program(code)(state, ts, args)

    @property
    def num_composed(self) -> int:
        return len(self._programs)

    @classmethod
    def from_program(cls, program, **kwargs):
        """Construct from a frozen SimProgram: the host-adapted registry
        plus a codec sized by the program's Config."""
        registry = program.host_registry()
        cfg = program.config
        codec = make_codec(cfg.codec, len(registry), cfg.max_batch_len)
        return cls(registry, codec, **kwargs)


class EagerComposer(_ComposerBase):
    """Paper-faithful: compose and compile every batch up front.

    ``state_spec``/``arg_spec`` describe one state and one handler
    argument, as example tensors or ``(shape, dtype)`` pairs (trees of
    them for the state); with a ``state_spec`` each word is compiled
    and called once on zeros of those shapes, so no compile is left
    for the run (JAX's ``.lower().compile()``).  ``arg_spec=None``
    means the fixed record, ``((ARG_WIDTH,), torch.float32)``.
    """

    def __init__(self, registry, codec, *, state_spec=None, arg_spec=None,
                 aot: bool = True, device=None, jit_handlers: bool = True):
        super().__init__(registry, codec, device=device,
                         jit_handlers=jit_handlers)
        self.aot = aot and state_spec is not None
        self.state_spec = state_spec
        self.arg_spec = arg_spec
        t0 = _time.perf_counter()
        for code in codec.enumerate_codes():
            word = self.word_for(code)
            if not word:
                continue  # redundant ν-only code (PaperCodec)
            if self.aot:
                self._programs[code] = self._aot_build(code, word)
            else:
                self._programs[code] = self._build(code)
        self.total_compile_seconds = _time.perf_counter() - t0

    def _aot_build(self, code, word):
        t0 = _time.perf_counter()
        prog = self._build(code)
        self._build_seconds[code] = _time.perf_counter() - t0
        if self.jit_handlers:
            # The warm call compiles the word (its ``first_call_s``).
            arg_spec = self.arg_spec
            if arg_spec is None:
                arg_spec = ((ARG_WIDTH,), torch.float32)
            arg = _spec_zeros(arg_spec, "cpu").numpy().reshape(-1)
            ts, args = batch_inputs([0.0] * len(word), [arg] * len(word),
                                    self.device)
            prog(_spec_zeros(self.state_spec, self.device), ts, args)
        return prog


class LazyComposer(_ComposerBase):
    """Beyond-paper (§IV.D): compile batches on first occurrence only."""
    # program() already builds lazily; nothing else needed.


# ---------------------------------------------------------------------------
# On-device dispatchers
# ---------------------------------------------------------------------------


def _emit_layout(max_len: int, max_emit: int):
    """Shared emit-block layout: ``f32[max_len * max_emit, 2 +
    ARG_WIDTH]`` rows of ``(time, type, arg...)``, event ``i`` owning
    rows ``[i*max_emit, (i+1)*max_emit)``; ``type == -1`` marks empty
    slots.  Returns ``(emit_width, empty_emits(device))``."""
    emit_rows = max_len * max_emit
    emit_width = 2 + ARG_WIDTH

    def empty_emits(device):
        e = torch.zeros((emit_rows, emit_width), dtype=torch.float32,
                        device=device)
        e[:, 1] = -1.0
        return e

    return emit_width, empty_emits


def _apply(et, state, emits, i, t, arg, max_emit, emit_width):
    """Run one handler for window lane ``i``, writing its emit rows."""
    result = call_handler(et.name, et.handler, state, t, arg)
    if not et.returns_events:
        return result, emits
    state, new = result
    new = torch.as_tensor(new, dtype=torch.float32, device=emits.device)
    if tuple(new.shape) != (max_emit, emit_width):
        raise ValueError(
            f"on-device handler {et.name} must emit "
            f"f32[{max_emit}, {emit_width}], got {tuple(new.shape)}")
    emits[i * max_emit:(i + 1) * max_emit] = new
    return state, emits


def make_word_branch(registry: EventRegistry, word: Sequence[int], *,
                     max_emit: int, emit_width: int,
                     empty_emits: Callable) -> Callable:
    """The composed straight-line program of one batch word:
    ``branch(state, ts, args) -> (state, emits)``."""
    types = [registry[t] for t in word]

    def branch(state, ts, args):
        emits = empty_emits(ts.device)
        for i, et in enumerate(types):
            state, emits = _apply(et, state, emits, i, ts[i], args[i],
                                  max_emit, emit_width)
        return state, emits

    branch.__name__ = "batch_" + "_".join(t.name for t in types)
    return branch


def _require_dense(codec, what: str):
    if not isinstance(codec, DenseCodec):
        raise TypeError(f"{what} requires the DenseCodec (contiguous ids)")


def build_switch_dispatcher(registry: EventRegistry, codec: DenseCodec, *,
                            max_emit: int = 2):
    """Dispatch over ALL composed batch words.

    ``dispatch(code, state, ts, args) -> (state, emits)`` runs the
    composed branch of word ``codec.decode(code)``; ``code`` is a host
    int.  Attributes: ``num_batches`` and ``empty_emits(device)``, the
    all-empty emit block.
    """
    _require_dense(codec, "on-device dispatch")
    registry.freeze()
    emit_width, empty_emits = _emit_layout(codec.max_len, max_emit)
    branches = [
        make_word_branch(registry, word, max_emit=max_emit,
                         emit_width=emit_width, empty_emits=empty_emits)
        for _code, word in codec.enumerate_words()
    ]

    def dispatch(code: int, state, ts, args):
        return branches[code](state, ts, args)

    def on_device(code, state, ts, args):
        """The same branch chosen on the device by the i32 ``code``."""
        return select(code, [
            lambda c, b=b: b(c[0], ts, args) for b in branches
        ], (state, empty_emits(ts.device)))

    dispatch.num_batches = codec.num_batches
    dispatch.empty_emits = empty_emits
    dispatch.on_device = on_device
    return dispatch


def build_masked_dispatcher(registry: EventRegistry, codec: DenseCodec, *,
                            max_emit: int = 2):
    """The per-lane masked path: ``dispatch(state, ts, types, args,
    length) -> (state, emits)`` with ``types`` (host ints, one per
    lane) and ``length`` (host int).  Lane ``i < length`` runs the
    handler of ``clip(types[i], 0, T - 1)``; later lanes are no-ops."""
    _require_dense(codec, "on-device dispatch")
    registry.freeze()
    num_types = len(registry)
    emit_width, empty_emits = _emit_layout(codec.max_len, max_emit)

    def dispatch(state, ts, types, args, length: int):
        emits = empty_emits(ts.device)
        for i in range(min(length, codec.max_len)):
            et = registry[min(max(types[i], 0), num_types - 1)]
            state, emits = _apply(et, state, emits, i, ts[i], args[i],
                                  max_emit, emit_width)
        return state, emits

    def on_device(state, ts, types, args, length):
        """The same legs chosen on the device: lane ``i`` selects its
        type's leg, none past the i32 ``length``."""
        def leg(i, et):
            return lambda c: _apply(et, c[0], c[1], i, ts[i], args[i],
                                    max_emit, emit_width)

        lanes = torch.arange(codec.max_len, device=ts.device)
        sel = torch.where(lanes < length,
                          torch.clamp(types, 0, num_types - 1), num_types)
        carry = (state, empty_emits(ts.device))
        for i in range(codec.max_len):
            carry = select(sel[i], [leg(i, registry[ty])
                                    for ty in range(num_types)], carry)
        return carry

    dispatch.on_device = on_device
    return dispatch


def build_fused_dispatcher(registry: EventRegistry, codec: DenseCodec,
                           hot_words: Sequence[Sequence[int]], *,
                           max_emit: int = 2):
    """Two-level composition-specialized dispatch (DESIGN.md §7).

    The hot words get their composed straight-line branches
    (:func:`make_word_branch`, the same bodies the switch dispatcher
    runs); every other word takes the masked path
    (:func:`build_masked_dispatcher`).  ``hot_slot_table`` maps each
    dense code to its hot slot, and slot ``num_hot`` is the fallback.

    ``dispatch(code, state, ts, types, args, length) -> (state,
    emits)`` with host ``code``, ``types`` and ``length``; each call
    adds one to ``COUNTS["fused_hot"]`` or ``COUNTS["fused_fallback"]``.

    Attributes: ``hot_words`` (the deduplicated tuple actually built),
    ``num_hot``, ``hot_slot_table`` (numpy ``int32[num_batches]``) and
    ``num_batches``.
    """
    _require_dense(codec, "fused dispatch")
    registry.freeze()
    max_len = codec.max_len
    num_types = len(registry)
    emit_width, empty_emits = _emit_layout(max_len, max_emit)

    seen: dict[tuple[int, ...], None] = {}
    for w in hot_words:
        word = tuple(int(t) for t in w)
        if not 1 <= len(word) <= max_len:
            raise ValueError(
                f"hot word {word} has length {len(word)}; expected "
                f"1..{max_len} (= max_batch_len)")
        for t in word:
            if not 0 <= t < num_types:
                raise ValueError(
                    f"hot word {word} names type id {t}; registry has "
                    f"{num_types} types")
        seen.setdefault(word, None)
    hot = tuple(seen)

    fallback = build_masked_dispatcher(registry, codec, max_emit=max_emit)
    branches = [
        make_word_branch(registry, word, max_emit=max_emit,
                         emit_width=emit_width, empty_emits=empty_emits)
        for word in hot
    ]
    table = np.full((codec.num_batches,), len(hot), np.int32)
    for slot, word in enumerate(hot):
        table[codec.encode(list(word))] = slot

    def dispatch(code: int, state, ts, types, args, length: int):
        slot = int(table[min(max(code, 0), codec.num_batches - 1)])
        if slot < len(hot):
            bump("fused_hot")
            return branches[slot](state, ts, args)
        bump("fused_fallback")
        return fallback(state, ts, types, args, length)

    tables: dict = {}

    def on_device(code, state, ts, types, args, length):
        """The same choice on the device: the slot gathered from a device
        copy of ``hot_slot_table`` (made on the first call, which must
        not be captured), then one branch a hot slot and the masked
        fallback."""
        dev = ts.device
        if dev not in tables:
            tables[dev] = torch.as_tensor(table, device=dev)
        slot = tables[dev].index_select(0, torch.clamp(
            code, 0, codec.num_batches - 1).long().reshape(1)).reshape(())

        def hot_branch(b):
            def run(c):
                bump("fused_hot")
                return b(c[0], ts, args)
            return run

        def fallback_branch(c):
            bump("fused_fallback")
            return fallback.on_device(c[0], ts, types, args, length)

        return select(slot, [hot_branch(b) for b in branches]
                      + [fallback_branch], (state, empty_emits(dev)))

    dispatch.hot_words = hot
    dispatch.num_hot = len(hot)
    dispatch.hot_slot_table = table
    dispatch.num_batches = codec.num_batches
    dispatch.on_device = on_device
    return dispatch


def hot_words_from_counts(counts, codec: DenseCodec, top_w: int):
    """Top-W batch words by observed frequency — the profile half of
    "profile or statically declare".

    ``counts`` is the engine's per-word histogram (``RunResult.
    word_counts``, numpy or torch, over dense codes) or a ``dict`` of
    code -> count.  Returns word tuples for ``build(...,
    hot_words=...)``; ties break toward the smaller code, and words
    never observed are never selected.
    """
    if hasattr(counts, "items"):
        pairs = list(counts.items())
    else:
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        pairs = list(enumerate(np.asarray(counts).reshape(-1).tolist()))
    ranked = sorted(
        ((int(n), int(code)) for code, n in pairs if int(n) > 0),
        key=lambda p: (-p[0], p[1]),
    )
    return [tuple(codec.decode(code)) for _, code in ranked[:int(top_w)]]
