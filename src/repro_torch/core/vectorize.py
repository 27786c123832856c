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
initial state).  Entity ids follow JAX's indexing rules, with no read
to the host: a negative id counts from the end once, the gather clamps
into range, and a lane whose id is still out of range changes nothing
(JAX's scatter drops it).  Duplicate entity ids among real lanes would
race, as in JAX: callers guarantee there are none, and nothing here
reads the ids to the host to check.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import tree_map


def _vmapped(local_handler: Callable, state_axis: int) -> Callable:
    return torch.func.vmap(local_handler, in_dims=(state_axis, 0, 0),
                           out_dims=state_axis)


def entity_index(ids: torch.Tensor, n: int):
    """JAX's entity indexing over ``n`` rows: ``(index, inside)``, the
    id wrapped once when negative and clamped into ``[0, n)``, and
    whether it lay in range after the wrap (a gather reads the clamped
    row; a scatter drops a lane that is not ``inside``)."""
    idx = torch.where(ids < 0, ids + n, ids)
    at = idx.clamp(0, n - 1)
    return at, at == idx


def make_run_handler(local_handler: Callable, *, state_axis: int = 0):
    """Lift an entity-local handler to a vectorized run handler
    ``(state, ts, args, entity_ids) -> state``.

    Every state leaf carries the entity dimension at ``state_axis``;
    ``entity_ids: int[k]`` selects the rows the run's events touch and
    ``ts: f32[k]``, ``args: f32[k, ARG_WIDTH]`` are batched likewise.
    """
    masked = make_masked_run_handler(local_handler, state_axis=state_axis)

    def run_handler(state, ts, args, entity_ids):
        return masked(state, ts, args, entity_ids,
                      torch.ones_like(entity_ids, dtype=torch.bool))

    return run_handler


def make_masked_run_handler(local_handler: Callable, *,
                            state_axis: int = 0):
    """Like :func:`make_run_handler`, for fixed-shape padded windows:
    ``(state, ts, args, entity_ids, mask) -> state`` with ``mask:
    bool[k]`` (on the state's device) marking the real lanes.

    Masked lanes gather their clamped id and change nothing, and
    neither does a real lane whose id is out of range after the wrap.
    PyTorch's scatters have no ``mode="drop"``, and selecting the lanes
    that write by their count would read it to the host, so they are
    selected by value instead: each lane that does not write is pointed
    at the first lane that does and carries that lane's row, so it
    writes what that lane writes (with no such lane, every lane writes
    the first lane's clamped row back as it is).  No index lies past the
    end, and every duplicate index carries one value, so the scatter's
    result does not depend on its order.  The index work depends only on
    the ids, the mask and a leaf's entity count, so it is done once a
    count, not once a leaf.
    """
    vh = _vmapped(local_handler, state_axis)

    def run_handler(state, ts, args, entity_ids, mask):
        ids = entity_ids.to(torch.int64)
        lanes = {}

        def lanes_for(n):
            if n not in lanes:
                at, inside = entity_index(ids, n)
                real = mask & inside
                first = torch.argmax(real.to(torch.int32)).reshape(1)
                fill_id = at.index_select(0, first)
                lanes[n] = (at, real, real.any(), first, fill_id,
                            torch.where(real, at, fill_id))
            return lanes[n]

        def gather(leaf):
            return leaf.index_select(state_axis,
                                     lanes_for(leaf.shape[state_axis])[0])

        new = vh(tree_map(gather, state), ts, args)

        def put(leaf, rows):
            _, real, any_real, first, fill_id, scatter_ids = lanes_for(
                leaf.shape[state_axis])
            lane_shape = [1] * rows.dim()
            lane_shape[state_axis] = -1
            rows = rows.to(leaf.dtype)
            fill = torch.where(any_real,
                               rows.index_select(state_axis, first),
                               leaf.index_select(state_axis, fill_id))
            return leaf.index_copy_(state_axis, scatter_ids,
                                    torch.where(real.reshape(lane_shape),
                                                rows, fill))

        return tree_map(put, state, new)

    return run_handler


def is_single_type_run(type_ids) -> bool:
    """Host-side check that an extracted window is a same-type run."""
    ids = list(type_ids)
    return len(ids) > 0 and all(t == ids[0] for t in ids)
