"""Batch composition for the device engine (paper §III-A), PyTorch port.

Counterpart of the on-device dispatchers of :mod:`repro.core.composer`.
A batch word ``w = [t0, t1, ...]`` becomes one straight-line program
that applies the handlers back to back (:func:`make_word_branch`), each
emitting into its own fixed row block.

JAX selects the branch on the device with ``lax.switch``.  Eager
PyTorch has no device-side switch, so the engine reads the window's
types and length to the host once per super-step and the dispatcher
runs the selected Python code:

* :func:`build_switch_dispatcher` — one composed branch per dense
  codec word, indexed by the host-side word code;
* :func:`build_masked_dispatcher` — one handler leg per window lane,
  selected by the lane's type, no-op past ``length``.

Both run the identical handler sequence with the identical emit layout,
so they are bit-identical to each other and to the JAX modes of the
same names.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.codec import DenseCodec
from repro_torch.core.events import ARG_WIDTH, EventRegistry


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
    result = et.handler(state, t, arg)
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
    int.
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

    return dispatch
