"""Same-type run vectorization (DESIGN.md §2), PyTorch port.

Counterpart of :mod:`repro.core.vectorize`.  A window that is a *run*
of one event type over independent entities runs as one
``torch.func.vmap`` of the type's entity-local handler,

    local_handler(entity_state, t, arg) -> entity_state

instead of one handler call per event.  The local handler must be
functional: ``vmap`` refuses ``.item()``, a Python branch on a tensor
and an in-place update of its inputs.

:func:`make_run_handler` gathers the run's entity rows with
``index_select``, applies the vmapped handler and scatters the rows
back with ``index_copy_``.  The scatter updates the state's leaves in
place and returns the state (the engine runs on its own copy of the
initial state).  Duplicate entity ids among real lanes would race, as
in JAX: callers guarantee there are none, and nothing here reads the
ids to the host to check.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import tree_map


def _vmapped(local_handler: Callable, state_axis: int) -> Callable:
    return torch.func.vmap(local_handler, in_dims=(state_axis, 0, 0),
                           out_dims=state_axis)


def make_run_handler(local_handler: Callable, *, state_axis: int = 0):
    """Lift an entity-local handler to a vectorized run handler
    ``(state, ts, args, entity_ids) -> state``.

    Every state leaf carries the entity dimension at ``state_axis``;
    ``entity_ids: int[k]`` selects the rows the run's events touch and
    ``ts: f32[k]``, ``args: f32[k, ARG_WIDTH]`` are batched likewise.
    """
    vh = _vmapped(local_handler, state_axis)

    def run_handler(state, ts, args, entity_ids):
        ids = entity_ids.to(torch.int64)
        sub = tree_map(lambda leaf: leaf.index_select(state_axis, ids),
                       state)
        new = vh(sub, ts, args)
        return tree_map(
            lambda leaf, rows: leaf.index_copy_(state_axis, ids,
                                                rows.to(leaf.dtype)),
            state, new)

    return run_handler


def make_masked_run_handler(local_handler: Callable, *,
                            state_axis: int = 0):
    """Like :func:`make_run_handler`, for fixed-shape padded windows:
    ``(state, ts, args, entity_ids, mask) -> state`` with ``mask:
    bool[k]`` (on the state's device) marking the real lanes.

    Masked lanes gather entity 0 and change nothing.  PyTorch's
    scatters have no ``mode="drop"``, and selecting the real lanes by
    the mask's count would read it to the host, so the real lanes are
    selected by value instead: each masked lane is pointed at the first
    real lane and carries that lane's row, so it writes what that lane
    writes (with no real lane, it writes entity 0's own row back).  No
    index lies past the end, and every duplicate index carries one
    value, so the scatter's result does not depend on its order.
    """
    vh = _vmapped(local_handler, state_axis)

    def run_handler(state, ts, args, entity_ids, mask):
        ids = entity_ids.to(torch.int64)
        zero = torch.zeros_like(ids[:1])
        gather_ids = torch.where(mask, ids, zero)
        sub = tree_map(lambda leaf: leaf.index_select(state_axis, gather_ids),
                       state)
        new = vh(sub, ts, args)
        any_real = mask.any()
        first = torch.argmax(mask.to(torch.int32)).reshape(1)
        fill_id = torch.where(any_real, ids.index_select(0, first), zero)
        scatter_ids = torch.where(mask, ids, fill_id)

        def put(leaf, rows):
            lane_shape = [1] * rows.dim()
            lane_shape[state_axis] = -1
            real = mask.reshape(lane_shape)
            rows = rows.to(leaf.dtype)
            fill = torch.where(any_real,
                               rows.index_select(state_axis, first),
                               leaf.index_select(state_axis, zero))
            return leaf.index_copy_(state_axis, scatter_ids,
                                    torch.where(real, rows, fill))

        return tree_map(put, state, new)

    return run_handler


def is_single_type_run(type_ids) -> bool:
    """Host-side check that an extracted window is a same-type run."""
    ids = list(type_ids)
    return len(ids) > 0 and all(t == ids[0] for t in ids)
