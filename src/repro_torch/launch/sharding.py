"""Partitioning rules: param / batch / cache placements for every arch
(PyTorch port of :mod:`repro.launch.sharding`).

Parallelism layout, as JAX's:

* **TP** over ``model``: attention heads (wq/wk/wv out-dim), wo in-dim,
  MLP hidden, MoE experts (EP), mamba d_inner, rwkv projections, vocab.
* **FSDP** over ``data``: the *other* matrix dim of every 2-D param;
  optimizer moments inherit leaf for leaf.
* **DP** over ``(pod, data)``: the batch dim of activations.  The pod
  axis appears ONLY here.

Rules are (regex over the leaf's path in JAX's ``keystr`` spelling,
:func:`repro_torch.core.tree.key_leaves`; spec for the TRAILING dims);
leading dims (the layer-stack axis) are padded with None.  First match
wins.  A spec is a :class:`~repro_torch.models.shards.P`, JAX's
``PartitionSpec``: one entry a tensor dim, ``None``, an axis name, or a
tuple of axis names; :func:`~repro_torch.models.shards.placements` turns
it into DTensor placements on a mesh, one a mesh dim: ``Shard(d)`` on the tensor dim ``d`` that names the mesh dim's
axis, else ``Replicate()`` (a ``("pod", "data")`` batch dim is
``Shard(0)`` on both).  The divisibility guard is JAX's: an axis that
does not divide its dim is dropped, though DTensor would take uneven
shards.

The activation anchors (:func:`shard_batch_dim`,
:func:`gather_head_for_unembed`, :func:`shard_seq_dim`) redistribute a
``DTensor`` inside an :func:`anchored` block, which registers the mesh
for the block alone (JAX keeps a module global, ``set_batch_axes``);
with no mesh registered, or on a plain tensor, each is the identity.
How the layers then run on each rank's shards is
:mod:`repro_torch.models.shards`.
"""

from __future__ import annotations

import contextlib
import contextvars
import re

from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.tree import key_leaves, tree_unflatten
from repro_torch.models.shards import (
    P,
    axis_sizes,
    dp_axes,
    guard,
    placements,
    size_of,
)


# ---------------------------------------------------------------------------
# Activation anchors
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("anchor_mesh",
                                                       default=None)


@contextlib.contextmanager
def anchored(mesh):
    """Register ``mesh`` for the activation anchors inside the block
    (``None``: no anchor), and restore what was registered before.  With
    a mesh, plain tensors that meet ``DTensor``s inside the block (an
    ``arange`` of positions, a mask) count as replicated
    (``implicit_replication``)."""
    token = _MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def anchor_mesh():
    """The mesh :func:`anchored` registered, or None."""
    return _MESH.get()


def _constrain(x, spec):
    """``x`` redistributed to ``spec`` on the registered mesh."""
    mesh = _MESH.get()
    return x.redistribute(mesh, placements(mesh, spec))


def _active(x) -> bool:
    return _MESH.get() is not None and isinstance(x, DTensor)


def shard_batch_dim(x, dim: int = 0):
    """Pin the batch dim to the DP axes (the embedding's output and
    ``embeds`` inputs: left alone, the gather from a vocab-sharded table
    comes back batch-REPLICATED, and every layer downstream would run the
    full batch on every data shard)."""
    if not _active(x):
        return x
    spec = [None] * x.ndim
    spec[dim] = dp_axes(_MESH.get())
    return _constrain(x, guard(x.shape, spec, axis_sizes(_MESH.get())))


def gather_head_for_unembed(head):
    """The unembedding table as ``P('model', None)`` right before the
    logits product: its FSDP dim is all-gathered once a use, instead of
    contracting the sharded d into partial logits and all-reducing the
    ``[B, T, V/TP]`` f32 logits."""
    if not _active(head):
        return head
    if head.shape[0] % 16 == 0:
        return _constrain(head, P("model", None))
    return head


def shard_seq_dim(x, batch_dim: int = 0, seq_dim: int = 1):
    """Sequence-parallel residual: batch over the DP axes AND the
    sequence dim over 'model' (Megatron-SP style)."""
    if not _active(x):
        return x
    if x.shape[seq_dim] % 16:
        return shard_batch_dim(x, batch_dim)
    spec = [None] * x.ndim
    spec[batch_dim] = dp_axes(_MESH.get())
    spec[seq_dim] = "model"
    return _constrain(x, guard(x.shape, spec, axis_sizes(_MESH.get())))


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------

# (path regex, trailing-dims spec). "fsdp" -> data, "tp" -> model.
_RULES: list[tuple[str, tuple]] = [
    # --- embeddings / head: [V, D] ---
    (r"embed|head", ("tp", "fsdp")),
    # --- rwkv channel-mix (must precede attention wk/wv rules) ---
    (r"ffn.*\bwk\b", ("fsdp", "tp")),
    (r"ffn.*\bwv\b", ("tp", "fsdp")),
    (r"ffn.*\bwr\b", ("fsdp", "tp")),
    # --- MoE ---
    (r"router", ("fsdp", None)),
    (r"experts.*(gate|up)", ("tp", "fsdp", None)),
    (r"experts.*down", ("tp", None, "fsdp")),
    (r"shared.*(gate|up)", ("fsdp", "tp")),
    (r"shared.*down", ("tp", "fsdp")),
    # --- attention (GQA + MLA) ---
    (r"\bwq\b|\bwk\b|\bwv\b", ("fsdp", "tp")),
    (r"\bwo\b", ("tp", "fsdp")),
    (r"wdkv", ("fsdp", "tp")),
    (r"wkr", ("fsdp", None)),
    (r"wuk|wuv", ("fsdp", "tp")),
    # --- dense MLP ---
    (r"gate|up", ("fsdp", "tp")),
    (r"down", ("tp", "fsdp")),
    # --- mamba ---
    (r"in_proj", ("fsdp", "tp")),
    (r"out_proj", ("tp", "fsdp")),
    (r"conv_w", (None, "tp")),
    (r"conv_b", ("tp",)),
    (r"x_proj", ("tp", None)),
    (r"dt_proj", (None, "tp")),
    (r"dt_bias", ("tp",)),
    (r"A_log", ("tp", None)),
    (r"\bD\b", ("tp",)),
    # --- rwkv time-mix ---
    (r"\bwg\b|\bwr\b", ("fsdp", "tp")),
    (r"decay_A", ("fsdp", None)),
    (r"decay_B", (None, "tp")),
    # everything else (norm scales, mixes, bonus_u, ...) replicated
]


def _spec_for(path: str, shape: tuple, sizes: dict, *,
              fsdp: bool = True) -> P:
    ndim = len(shape)
    for pat, core in _RULES:
        if re.search(pat, path):
            core = tuple(
                ("model" if a == "tp" else
                 ("data" if (a == "fsdp" and fsdp) else None))
                for a in core)
            if len(core) > ndim:   # e.g. scalar-ish leaves
                core = core[-ndim:]
            # divisibility guard: drop axes that don't divide the dim
            # (e.g. 36-head minicpm attention on a 16-way model axis).
            return guard(shape, (None,) * (ndim - len(core)) + core, sizes)
    return P(*((None,) * ndim))


def _map_specs(tree, spec_of):
    return tree_unflatten(tree, [spec_of(path, leaf)
                                 for path, leaf in key_leaves(tree)])


def param_specs(mesh, params, *, fsdp: bool = True):
    """The spec of every leaf of a JAX-layout param tree."""
    sizes = axis_sizes(mesh)
    return _map_specs(params, lambda path, leaf: _spec_for(
        path, tuple(leaf.shape), sizes, fsdp=fsdp))


def state_specs(mesh, state, *, fsdp: bool = True):
    """TrainState specs: m/v/ef mirror params; step replicated."""
    out = {"params": param_specs(mesh, state["params"], fsdp=fsdp),
           "opt": {"m": param_specs(mesh, state["opt"]["m"], fsdp=fsdp),
                   "v": param_specs(mesh, state["opt"]["v"], fsdp=fsdp),
                   "step": P()}}
    if "ef" in state:
        out["ef"] = param_specs(mesh, state["ef"], fsdp=fsdp)
    return out


def batch_specs(mesh, batch):
    """Batch-dim DP specs for input trees (tokens/labels/embeds);
    M-RoPE 'positions' have shape (3, B, T): batch is dim 1."""
    dp = dp_axes(mesh)

    def spec(path, leaf):
        if "positions" in path and leaf.ndim == 3:
            return P(None, dp, *(None,) * (leaf.ndim - 2))
        return P(dp, *(None,) * (leaf.ndim - 1))

    return _map_specs(batch, spec)


def cache_specs(mesh, cache, *, batch: int):
    """Decode-cache specs.  Cache leaves are [L, B, S, ...] (attention)
    or [L, B, ...] (states).  If the batch covers the DP axes, shard
    batch over DP and the seq dim over model; for tiny batches
    (long_500k: B=1) shard the SEQ dim over all axes instead."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_n = size_of(sizes, dp)
    covers = batch % dp_n == 0 and batch >= dp_n

    def spec(name, leaf):
        nd = leaf.ndim
        if "lengths" in name:
            return P()
        bdim = dp if covers else None
        if re.search(r"\['k'\]$|\['v'\]$|ckv|kr", name):
            # attention caches [L, B, S, ...]
            sdim = "model" if covers else dp + ("model",)
            return guard(leaf.shape, (None, bdim, sdim) + (None,) * (nd - 3),
                         sizes)
        if "conv" in name:     # [L, B, K-1, I]
            return guard(leaf.shape, (None, bdim, None, "model"), sizes)
        if re.search(r"x_att|x_ffn", name):   # [L, B, 1, D]
            return guard(leaf.shape, (None, bdim, None, "model"), sizes)
        if name.endswith("['h']"):            # mamba [L, B, I, N]
            return guard(leaf.shape, (None, bdim, "model", None), sizes)
        if name.endswith("['S']"):            # rwkv [L, B, H, K, V]
            return guard(leaf.shape, (None, bdim, "model", None, None),
                         sizes)
        return P(*((None,) * nd))

    return _map_specs(cache, spec)


def module_param_specs(mesh, model, *, fsdp: bool = True) -> dict:
    """The spec of each of an ``LM``'s own parameters, by name: its
    leaf's rule on the JAX path (``LM.param_paths``), without the stack
    dim, which no rule shards."""
    sizes = axis_sizes(mesh)
    paths = model.param_paths()
    return {name: _spec_for(paths[name], tuple(p.shape), sizes, fsdp=fsdp)
            for name, p in model.named_parameters()}


def distribute_lm(model, mesh, *, fsdp: bool = True):
    """Replace an ``LM``'s own parameters, in place, by ``DTensor``
    parameters on ``mesh`` at their rules' placements; returns
    ``model``."""
    specs = module_param_specs(mesh, model, fsdp=fsdp)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod.register_parameter(leaf, nn.Parameter(
            distribute(p.detach(), mesh, specs[name]), requires_grad=False))
    return model


def placements_of(mesh, tree, specs):
    """``tree``'s structure with each leaf's placements on ``mesh``, from
    ``specs`` (the tree of its specs)."""
    return tree_unflatten(tree, [placements(mesh, spec)
                                 for _, spec in key_leaves(specs)])


def distribute(tree, mesh, specs):
    """``tree`` with each tensor leaf a ``DTensor`` on ``mesh`` at its
    spec (``distribute_tensor``: every rank holds the same values; on a
    mesh of one rank each tensor is its own shard, and is not copied)."""
    def place(leaf, spec):
        if mesh.size() == 1:
            return DTensor.from_local(leaf, mesh, placements(mesh, spec),
                                      run_check=False)
        return distribute_tensor(leaf, mesh, placements(mesh, spec))

    return tree_unflatten(tree, [
        place(leaf, spec) for (_, leaf), (_, spec) in zip(key_leaves(tree),
                                                          key_leaves(specs))])


def param_placements(mesh, params, *, fsdp: bool = True):
    return placements_of(mesh, params, param_specs(mesh, params,
                                                   fsdp=fsdp))


def state_placements(mesh, state, *, fsdp: bool = True):
    return placements_of(mesh, state, state_specs(mesh, state, fsdp=fsdp))


def batch_placements(mesh, batch):
    return placements_of(mesh, batch, batch_specs(mesh, batch))


def cache_placements(mesh, cache, *, batch: int):
    return placements_of(mesh, cache, cache_specs(mesh, cache, batch=batch))
