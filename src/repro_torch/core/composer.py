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
  selected by the lane's type, no-op past ``length``;
* :func:`build_fused_dispatcher` — the two-level composition of
  DESIGN.md §7: the hot words' composed branches, and the masked path
  for every other word.

All three run the identical handler sequence with the identical emit
layout, so they are bit-identical to each other and to the JAX modes of
the same names.

How the fused slot is chosen on this stack: the engine already holds
the window's word code on the host (it read the window's types and
length once), so the slot is a host lookup in ``hot_slot_table`` and
fused dispatch costs no device read beyond what ``switch`` costs.  A
selection on the device (the slot as a tensor, the branches behind a
device-side predicate) is what a captured CUDA graph would need, since
a graph cannot take a host branch per step; that is for the captured
loop (ROADMAP A5), which can also take the ``masked`` path with no
read of the word at all.  In eager PyTorch a hot branch runs the same
aten calls as the ``switch`` branch of its word: nothing compiles
across the handlers here, so the paper's cross-event scope is not
recovered on this stack until the hot branches are compiled or
captured.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.codec import DenseCodec
from repro_torch.core.events import ARG_WIDTH, EventRegistry
from repro_torch.core.queue import COUNTS


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

    dispatch.num_batches = codec.num_batches
    dispatch.empty_emits = empty_emits
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
            COUNTS["fused_hot"] += 1
            return branches[slot](state, ts, args)
        COUNTS["fused_fallback"] += 1
        return fallback(state, ts, types, args, length)

    dispatch.hot_words = hot
    dispatch.num_hot = len(hot)
    dispatch.hot_slot_table = table
    dispatch.num_batches = codec.num_batches
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
