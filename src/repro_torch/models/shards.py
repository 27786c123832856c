"""How the model's operations run on a device mesh's shards.

The mechanics beneath the sharding rules (:mod:`repro_torch.launch.
sharding`): the spec type :class:`P` (JAX's ``PartitionSpec``), its
DTensor :func:`placements`, JAX's divisibility guard, and
:func:`on_shards`, which runs a function of plain tensors on each
rank's shards of ``DTensor`` arguments, so that no kernel wrapper, scan
or attention core sees a ``DTensor``.  The layers call these; the rules
and the activation anchors, which decide where tensors are placed, stay
in :mod:`repro_torch.launch.sharding`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
)

from repro_torch.core.tree import key_leaves, tree_unflatten


class P:
    """JAX's ``PartitionSpec``: one entry a tensor dim (``None``, an axis
    name or a tuple of names).  Not a tuple, so that a tree of specs has
    one leaf a spec (:func:`repro_torch.core.tree.key_leaves`)."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"P{self.axes!r}"


def dp_axes(mesh) -> tuple:
    """The axes carrying the batch dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def size_of(sizes: dict, ax) -> int:
    """The ranks that ``ax`` (None, an axis name or a tuple) spans."""
    if ax is None:
        return 1
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return n


def guard(shape, spec, sizes: dict) -> P:
    """Drop the axes that do not divide their dim (or exceed it)."""
    return P(*(ax if dim % size_of(sizes, ax) == 0
                 and dim >= size_of(sizes, ax) else None
                 for dim, ax in zip(shape, spec)))


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def on_shards(fn, args: tuple, specs: tuple, out_specs):
    """``fn(*args)`` on each rank's shards (``local_map``): every
    ``DTensor`` argument redistributed to its spec, ``fn`` run on the
    local tensors, and its output (a tensor, or a tuple of them) wrapped
    as ``DTensor``s of ``out_specs``.  A spec is a :class:`P` or a tuple
    of placements, one a mesh dim (``Partial()`` for a partial sum);
    ``out_specs`` is one spec, or a tuple of them, one an output.  Plain
    arguments pass through; with no ``DTensor`` argument this is
    ``fn(*args)``.  ``fn`` must compute each output shard from the input
    shards alone, as the specs say: the kernels' wrappers, the attention
    cores and the scans never see a ``DTensor``.

    Gradients: an argument replicated over a mesh dim along which the
    outputs are split (sharded or partial) gets its local gradient as a
    partial sum over that dim, since each rank's share of the work
    contributes to it."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)

    def places(spec):
        return tuple(placements(mesh, spec) if isinstance(spec, P) else spec)

    single = isinstance(out_specs, P) or all(
        isinstance(x, Placement) for x in out_specs)
    outs = [places(out_specs)] if single else [places(s) for s in out_specs]
    split = [any(not o[d].is_replicate() for o in outs)
             for d in range(mesh.ndim)]
    local = []
    for a, spec in zip(args, specs):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        pl = places(spec)
        grad = [Partial() if p.is_replicate() and split[d] else p
                for d, p in enumerate(pl)]
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=grad))
    out = fn(*local)

    def wrap(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)

    if single:
        return wrap(out, outs[0])
    return tuple(wrap(t, pl) for t, pl in zip(out, outs, strict=True))


def split_spec(x, dims: dict) -> P:
    """The spec of the ``DTensor`` ``x`` that shards tensor dim ``d`` over
    ``dims[d]`` (``"batch"``: the DP axes; an axis name), each dropped
    where it does not divide the dim (JAX's guard)."""
    mesh = x.device_mesh
    spec = [None] * x.ndim
    for d, ax in dims.items():
        spec[d] = dp_axes(mesh) if ax == "batch" else ax
    return guard(x.shape, spec, axis_sizes(mesh))


def spec_of(x) -> P:
    """The spec of the ``DTensor`` ``x``'s placements: each tensor dim's
    sharding mesh axes in mesh order (a tuple), or None."""
    mesh = x.device_mesh
    axes = [tuple(name for name, pl in zip(mesh.mesh_dim_names,
                                           x.placements)
                  if isinstance(pl, Shard) and pl.dim == d)
            for d in range(x.ndim)]
    return P(*(a or None for a in axes))


def sharded_over(x, dim: int) -> list:
    """The mesh axes of more than one rank that shard ``x``'s tensor dim
    ``dim``, in mesh order (a plain tensor: none)."""
    if not isinstance(x, DTensor):
        return []
    mesh = x.device_mesh
    return [name for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape,
                                           x.placements)
            if size > 1 and isinstance(pl, Shard) and pl.dim == dim]


def block_offset(x, dim: int) -> int:
    """The first index of this rank's block of the ``DTensor`` ``x``'s
    tensor dim ``dim`` (blocks nest in mesh order)."""
    mesh = x.device_mesh
    block, off = x.shape[dim], 0
    for name, size, pl in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            block //= size
            off += mesh.get_local_rank(name) * block
    return off


def split_last(x, sizes: tuple):
    """``x.reshape(*x.shape[:-1], *sizes)``; on a ``DTensor`` whose last
    dim is sharded over ranks that do not divide ``sizes[0]`` (8 KV
    heads on a 16-way ``model`` axis), that dim is gathered first: a
    shard must hold whole heads."""
    if isinstance(x, DTensor):
        d = x.ndim - 1
        n = math.prod(size for size, pl in zip(x.device_mesh.shape,
                                                x.placements)
                      if isinstance(pl, Shard) and pl.dim == d)
        if sizes[0] % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim == d else pl
                for pl in x.placements])
    return x.reshape(*x.shape[:-1], *sizes)


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` (zeros); a ``DTensor`` is padded on each
    rank's shard, at its own placements (the padded dims must not be
    split; a partial sum is reduced first)."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths)
    spec = spec_of(x)
    return on_shards(lambda t: F.pad(t, widths), (x,), (spec,), spec)


def zeros(tree, mesh, specs, device):
    """Zeros of ``tree``'s shapes and dtypes (its leaves may be on the
    meta device) as ``DTensor``s on ``mesh`` at their specs, each rank
    allocating only its shard (JAX's guard keeps every split even)."""
    sizes = axis_sizes(mesh)

    def make(leaf, spec):
        axes = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        local = torch.zeros([n // size_of(sizes, ax)
                             for n, ax in zip(leaf.shape, axes)],
                            dtype=leaf.dtype, device=device)
        stride = [1] * leaf.ndim
        for d in range(leaf.ndim - 2, -1, -1):
            stride[d] = stride[d + 1] * leaf.shape[d + 1]
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=leaf.shape,
                                  stride=tuple(stride))

    return tree_unflatten(tree, [make(leaf, spec) for (_, leaf), (_, spec)
                                 in zip(key_leaves(tree), key_leaves(specs))])
