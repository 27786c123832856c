"""Cost model over the aten operations of a cell's step (the PyTorch
port's counterpart of :mod:`repro.launch.hlo_cost`, which walks XLA's
optimized HLO; there is no HLO here).

:func:`trace_cost` runs a function on fake tensors (the avatars of
:func:`repro_torch.launch.specs.build_cell`: shapes and dtypes, no
memory) under a dispatch mode that sees every aten operation as it is
dispatched, the forward's and autograd's backward's alike: the graph
``make_fx`` would record.  It counts, as JAX's model does:

* **FLOPs**: ``2 * M * N * K`` for every matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, their ``out_dtype`` overloads, and
  the matrix-vector ``mv``, ``addmv``, ``dot``;
  ``einsum`` reaches them as ``bmm``/``mm`` of views), and
  :mod:`torch.utils.flop_counter`'s formula for the other products it
  knows (convolutions, fused attention).  Elementwise work is excluded,
  the convention of the 6·N·D model FLOPs.
* **Bytes**: operand plus result bytes of every operation that
  materializes a tensor.  The eager port fuses nothing, so this is the
  traffic it does.  Views count 0 (``view``, ``select``, ``slice``,
  ``unbind``, ``t``, ``permute``, ``expand``, ``as_strided``, ...: a
  view's own bytes are counted where an operation reads it, so a layer's
  slice of a stacked weight counts the slice).  Three rules follow
  JAX's: a gather (``embedding``, ``index_select``, ``gather``,
  ``index``) reads at most its result's bytes of its source; an
  in-place row update (``index_put_``, ``index_copy_``, ``scatter_``,
  ``index_add_``) moves its index and twice its update, not the
  destination; ``copy_`` reads its source and writes its destination.
  Allocations (``empty``) and queries (``prim.device``, ``item``) move
  nothing.
* **Collective bytes**: the operand bytes a device sends into each
  ``_c10d_functional`` collective (``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``,
  ``broadcast``; ``wait_tensor`` counts 0), by op in ``coll_by_op`` and
  by the mesh axes of its group in ``coll_by_group``.  0 on one device.
* **Peak live bytes** (``peak_bytes``): the largest sum, over the trace,
  of the bytes of the tensors the step made that are still alive (each
  freed when its last reference goes, as the eager port frees it):
  the temporaries beside the argument and output bytes, the
  counterpart of XLA's ``memory_analysis()`` temp bytes.

On a mesh (``DTensor`` avatars over a fake process group,
:func:`repro_torch.launch.specs.build_cell` with ``mesh=``) every count
is **per device**: the mode does not count an operation on ``DTensor``s,
which is the global one, but the local operations and collectives that
``DTensor``'s dispatch issues under it on each rank's shards
(``CostMode`` declines the ``DTensor``-level operation, so the dispatch
re-enters it with local tensors).  The global-shape operations that
``DTensor``'s sharding propagation runs to infer shapes are not counted:
the mode pauses over them.

Repetition.  JAX's layers are one ``lax.scan`` and its microbatches
another, and its model multiplies a ``while`` body by its trip count.
The port's Python loops unroll, so :func:`cell_cost` traces a cell at
one and two units of its repeated layer pattern (and, for a train
step, at two and three microbatches) and extends the count linearly
(bilinearly for train) to the cell's own depth and microbatch count.
Every term is linear in each: the units are identical, the optimizer's
and the cache's work scale with the stacked leaves.  The cells of
:data:`EXTEND_T` (every 32k prefill, and the train steps of jamba and
rwkv6, whose plain scans step through the sequence) are also traced at
three cut sequence lengths and extended to their own: each term is
``a + b·T + c·P(T)``, ``P`` the block pairs the blockwise attention
visits (:func:`block_pairs`), since the scans' and projections' work
grows with T and the attention's with its block pairs.
``tests/test_torch_cost_extension.py`` holds the extended count equal
to the full trace's at 3 pattern units of every layer family (GQA and
MLA attention, dense and MoE feed-forwards, deepseek's dense first
layer, jamba's mamba/MoE pattern, RWKV) at a reduced size, and the
extension in T equal to the full trace at a longer T.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from fractions import Fraction

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default

# Cells traced at cut sequence lengths and extended in T, by shape or
# (arch, shape): a 32k prefill's blockwise attention runs ~62k aten ops
# a layer, and the train steps of jamba and rwkv6 run their plain scans
# a token or a chunk at a time (rwkv6's full trace took 203 s).
EXTEND_T = {"prefill_32k", ("jamba-1.5-large-398b", "train_4k"),
            ("rwkv6-1.6b", "train_4k")}

_COLLECTIVES = {"all_gather_into_tensor", "reduce_scatter_tensor",
                "all_reduce", "all_to_all_single", "broadcast"}

_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.mv,
            aten.addmv, aten.dot}
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index}
_ROW_UPDATES = {aten.index_put_, aten._index_put_impl_, aten.index_copy_,
                aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
                aten.index_add_}
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided,
           aten.new_empty, aten.new_empty_strided}


@dataclasses.dataclass
class Cost:
    """``flops`` is split by the products' operand dtype in
    ``flops_by_dtype`` (the H100 runs bf16 and f32 products at different
    rates; the roofline prices each)."""

    flops: float = 0.0
    # Every byte but the gathers' reads of their sources (below).
    other_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    # Collective operand bytes by the mesh axes of the group
    # ("model", "data", "pod"; "pod,data" for a group over both).
    coll_by_group: dict = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    # The gathers by their source's bytes: {source bytes: [gathers,
    # bytes they fetched]}; each reads at most its source.
    gather_reads: dict = dataclasses.field(default_factory=dict)

    @property
    def mem_bytes(self) -> float:
        """Operand plus result bytes, a gather reading at most its
        source's bytes (kept apart, so that a count extended in length,
        whose fetches grow with it, still caps each at its source)."""
        return self.other_bytes + sum(
            n * min(src, got / n) for src, (n, got) in
            self.gather_reads.items() if n)

    def __add__(self, o: "Cost") -> "Cost":
        return _combine([self, o], [1, 1])

    def scaled(self, k: float) -> "Cost":
        return _combine([self], [k])

    def add_flops(self, n: float, dtype: torch.dtype) -> None:
        self.flops += n
        key = str(dtype).removeprefix("torch.")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n

    def __sub__(self, o: "Cost") -> "Cost":
        return self + o.scaled(-1.0)


def _add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def _left(packet, args):
    """A product's left matrix operand (``addmm``, ``baddbmm`` and
    ``addmv`` carry the bias first)."""
    return args[1] if packet in (aten.addmm, aten.baddbmm, aten.addmv) \
        else args[0]


def _coords(grid, at=()):
    """(coordinate, entry) of every entry of a nested list."""
    if isinstance(grid, list):
        for i, sub in enumerate(grid):
            yield from _coords(sub, at + (i,))
    else:
        yield at, grid


class CostMode(TorchDispatchMode):
    """Counts :class:`Cost` over every aten operation dispatched inside
    it; run it inside the avatars' ``FakeTensorMode``.

    An operation on ``DTensor``s is declined (``NotImplemented``), so
    ``DTensor``'s dispatch runs and its local operations and collectives
    come back through the mode.  Every other operation is counted, but
    inside the two pauses below (:func:`_uncounted_shape_inference`,
    :func:`_strided_shard_sizes_outside_fake_mode`), where DTensor runs
    global-shape operations of its own to infer shapes."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._groups: dict = {}
        self._mesh = None
        self._live = 0

    def _group(self, name: str) -> str:
        """A process group's name -> the mesh axes its ranks span
        (``"pod,data"`` for a group over two)."""
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )

            from torch._subclasses.fake_tensor import unset_fake_temporarily

            ranks = set(dist.get_process_group_ranks(
                _resolve_process_group(name)))
            mesh = self._mesh
            with unset_fake_temporarily():
                grid = mesh.mesh.tolist()
            coords = [c for c, r in _coords(grid) if r in ranks]
            self._groups[name] = ",".join(
                dim for i, dim in enumerate(mesh.mesh_dim_names)
                if len({c[i] for c in coords}) > 1)
        return self._groups[name]

    def _note_mesh(self, args) -> None:
        for x in tree_leaves(args):
            if isinstance(x, DTensor):
                self._mesh = x.device_mesh

    def _freed(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:             # a query, asked ~once an operation
            return func(*args)
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self._note_mesh((args, kwargs))
            return NotImplemented
        out = func(*args, **kwargs)
        if _PAUSED[0]:
            return out      # the sharding propagation's own operations
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        c = self.cost
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            if name in _COLLECTIVES:
                n = float(_nbytes(ins[0]))
                group = self._group(args[-1])
                c.coll_bytes += n
                d = c.coll_by_op.setdefault(name, {"bytes": 0.0,
                                                   "count": 0.0})
                d["bytes"] += n
                d["count"] += 1
                c.coll_by_group[group] = c.coll_by_group.get(group, 0.0) + n
            self._track(outs, ins)
            return out
        if packet in _MATMULS:
            # the result's elements times twice the contracted size
            a = _left(packet, args)
            c.add_flops(2.0 * out.numel() * a.shape[-1], a.dtype)
        elif packet in flop_registry:
            c.add_flops(float(flop_registry[packet](
                *args, **kwargs, out_val=out)), args[0].dtype)
        if func.is_view or not outs:
            return out      # a view or a query
        self._track(outs, ins)
        if packet in _ALLOCS:
            return out      # an allocation moves nothing
        if packet in _ROW_UPDATES:
            c.other_bytes += sum(_nbytes(x) for x in ins[1:]) + sum(
                _nbytes(x) for x in ins[-1:])
        elif packet is aten.copy_:
            c.other_bytes += _nbytes(args[0]) + _nbytes(args[1])
        elif packet in _GATHERS:
            got = sum(_nbytes(x) for x in outs)
            c.other_bytes += sum(_nbytes(x) for x in ins[1:]) + got
            reads = c.gather_reads.setdefault(_nbytes(ins[0]), [0, 0])
            reads[0] += 1
            reads[1] += got
        else:
            c.other_bytes += (sum(_nbytes(x) for x in ins)
                              + sum(_nbytes(x) for x in outs))
        return out

    def _track(self, outs, ins) -> None:
        """Count each new output's bytes live until it is freed (a meta
        tensor, a shape alone, holds none)."""
        for x in outs:
            if any(x is y for y in ins) or x.is_meta:
                continue            # in place: no new tensor
            n = _nbytes(x)
            self._live += n
            weakref.finalize(x, self._freed, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)


# Set while DTensor computes a strided shard's size (below): the mode
# counts nothing then.
_PAUSED = [0]


@contextlib.contextmanager
def _strided_shard_sizes_outside_fake_mode():
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` computes a
    shard's size from ``torch.arange(...)``, which a ``FakeTensorMode``
    on the stack turns into a fake tensor whose ``tolist()`` raises (a
    data-dependent output); the sharding propagation then fails on a
    strided shard (a reshape that merges a batch dim sharded over one
    axis with a dim sharded over another).  Inside this block the size
    is computed with the fake mode unset, on a real index tensor of the
    dim's length, and uncounted."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = getattr(placement_types, "_StridedShard", None)
    if cls is None or "local_shard_size_and_offset" not in vars(cls):
        yield
        return
    orig = vars(cls)["local_shard_size_and_offset"]

    def sized(*args, **kwargs):
        _PAUSED[0] += 1
        try:
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        finally:
            _PAUSED[0] -= 1

    setattr(cls, "local_shard_size_and_offset", sized)
    try:
        yield
    finally:
        setattr(cls, "local_shard_size_and_offset", orig)


@contextlib.contextmanager
def _uncounted_shape_inference():
    """DTensor infers an operation's output shape by running it on
    global-shape fake tensors it makes for the purpose
    (``ShardingPropagator._propagate_tensor_meta_non_cached``); inside
    this block the mode counts none of that."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = vars(ShardingPropagator).get(name)
    if orig is None:
        yield
        return

    def infer(*args, **kwargs):
        _PAUSED[0] += 1
        try:
            return orig(*args, **kwargs)
        finally:
            _PAUSED[0] -= 1

    setattr(ShardingPropagator, name, infer)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def trace_cost(fn, *args, fake_mode=None, **kwargs) -> Cost:
    """The :class:`Cost` of one call ``fn(*args, **kwargs)`` on fake
    tensors (inside ``fake_mode``, the avatars' mode, when given)."""
    mode = CostMode()
    mode._note_mesh((args, kwargs))
    with (fake_mode if fake_mode is not None else contextlib.nullcontext()):
        with _strided_shard_sizes_outside_fake_mode(), \
                _uncounted_shape_inference(), mode:
            fn(*args, **kwargs)
    return mode.cost


def _linear(cost_at, n: int, n0: int) -> Cost:
    """``cost(n)`` of a cost linear in ``n``, from traces at ``n0`` and
    ``n0 + 1``."""
    c0 = cost_at(n0)
    if n == n0:
        return c0
    return c0 + (cost_at(n0 + 1) - c0).scaled(n - n0)


def block_pairs(T: int, q_block: int, kv_block: int, causal: bool) -> int:
    """The (query block, KV block) pairs ``blockwise_attention`` visits
    at length T: every pair, or causally those not wholly in the
    future."""
    qb, kb = min(q_block, T), min(kv_block, T)
    nq, nk = -(-T // qb), -(-T // kb)
    if not causal:
        return nq * nk
    return sum(1 for qi in range(nq) for ki in range(nk)
               if ki * kb <= qi * qb + qb - 1)


def cut_lengths(cfg, rows: int, T: int):
    """Three sequence lengths to trace a cell of ``rows`` sequences at,
    on which every length-dependent size is the full cell's: multiples of
    the attention blocks and the scans' chunks, two or more of each (a
    loop of one skips its concatenation), and, with MoE layers,
    enough tokens for the full 1024-token dispatch groups; None when the
    three together are no shorter than T (jamba's 4096-token train step,
    whose 1024-token attention blocks and groups set its cuts at 1024,
    2048 and 3072: its whole trace is the cheaper)."""
    kinds = {spec.mixer for pattern, _ in cfg.stages() for spec in pattern}
    ffns = {spec.ffn for pattern, _ in cfg.stages() for spec in pattern}
    unit, least = 1, 1
    if kinds & {"gqa", "mla"}:
        unit = math.lcm(unit, cfg.attn_q_block, cfg.attn_kv_block)
        least = max(least, 2 * cfg.attn_q_block)
    if "mamba" in kinds:
        unit = math.lcm(unit, cfg.mamba.chunk)
        least = max(least, 2 * cfg.mamba.chunk)
    if "rwkv" in kinds:
        unit = math.lcm(unit, cfg.rwkv_chunk)
        least = max(least, 2 * cfg.rwkv_chunk)
    if "moe" in ffns:
        unit = math.lcm(unit, 1024 // math.gcd(rows, 1024))
        least = max(least, -(-1024 // rows))
    k0 = -(-least // unit)
    ts = [unit * k for k in (k0, k0 + 1, k0 + 2)]
    return ts if sum(ts) < T else None


def _combine(costs, weights) -> Cost:
    """``sum(w * c)`` computed exactly (in fractions) on integer counts."""

    def mix(values):
        return float(sum(Fraction(v) * w for v, w in zip(values, weights)))

    def mix_dict(dicts):
        keys = sorted({k for d in dicts for k in d})
        return {k: mix([d.get(k, 0.0) for d in dicts]) for k in keys}

    ops = sorted({op for c in costs for op in c.coll_by_op})
    srcs = sorted({src for c in costs for src in c.gather_reads})
    return Cost(
        flops=mix([c.flops for c in costs]),
        other_bytes=mix([c.other_bytes for c in costs]),
        coll_bytes=mix([c.coll_bytes for c in costs]),
        coll_by_op={op: {f: mix([c.coll_by_op.get(op, {}).get(f, 0.0)
                                 for c in costs])
                         for f in ("bytes", "count")} for op in ops},
        flops_by_dtype=mix_dict([c.flops_by_dtype for c in costs]),
        coll_by_group=mix_dict([c.coll_by_group for c in costs]),
        peak_bytes=mix([c.peak_bytes for c in costs]),
        gather_reads={src: [mix([c.gather_reads.get(src, (0, 0))[i]
                                 for c in costs]) for i in (0, 1)]
                      for src in srcs})


def _in_length(cost_at, cfg, ts, T: int) -> Cost:
    """``cost(T)`` from traces at the lengths ``ts``, each term
    ``a + b·T + c·block_pairs(T)`` (``a + b·T`` from the first two,
    without attention); the peak of live bytes ``a + b·T``."""
    if not {spec.mixer for pattern, _ in cfg.stages()
            for spec in pattern} & {"gqa", "mla"}:
        k = Fraction(T - ts[0], ts[1] - ts[0])
        return _combine([cost_at(t) for t in ts[:2]], [1 - k, k])

    def basis(t):
        return [Fraction(1), Fraction(t), Fraction(block_pairs(
            t, cfg.attn_q_block, cfg.attn_kv_block, cfg.causal))]

    # weights w with sum_i w_i basis(t_i) = basis(T) (Cramer's rule)
    rows = [basis(t) for t in ts]
    target = basis(T)

    def det(m):
        return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
                - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
                + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))

    cols = [list(r) for r in zip(*rows)]       # basis fn x point
    d = det(cols)
    weights = []
    for i in range(3):
        m = [list(c) for c in cols]
        for j in range(3):
            m[j][i] = target[j]
        weights.append(det(m) / d)
    costs = [cost_at(t) for t in ts]
    out = _combine(costs, weights)
    # the peak is no sum of operations: extended linearly from the last
    # two lengths (the live activations and caches grow with T)
    k = Fraction(T - ts[1], ts[2] - ts[1])
    out.peak_bytes = _combine(costs[1:], [1 - k, k]).peak_bytes
    return out


def cell_cost(cell, *, extend_t: bool | None = None) -> Cost:
    """The cost of a :class:`~repro_torch.launch.specs.CellSpec` at its
    own depth and microbatch count, from traces of the same cell cut to
    one and two units of its repeated pattern (two and three
    microbatches of the same size for a train step): exact where every
    term is linear in each, as the module docstring argues.  With
    ``extend_t`` (default: the cell is in :data:`EXTEND_T`) each of
    those is traced at three cut lengths and extended to the cell's."""
    from repro_torch.launch.specs import build_cell

    cfg = cell.cfg
    pattern_len = len(cfg.block_pattern)
    extra = len(cfg.first_layer_pattern or ())
    repeat = (cfg.num_layers - extra) // pattern_len
    nm = cell.static_info.get("num_microbatches", 1)
    micro = cell.shape_spec["global_batch"] // nm
    T = cell.shape_spec["seq_len"]
    if extend_t is None:
        extend_t = (cell.shape in EXTEND_T
                    or (cell.arch, cell.shape) in EXTEND_T)

    def at(r: int, m: int, t: int) -> Cost:
        cut = dataclasses.replace(cfg, num_layers=extra + pattern_len * r)
        shape = dict(cell.shape_spec, global_batch=micro * m, seq_len=t)
        kw = dict(cell.build_kw)
        if cell.kind == "train":
            kw["num_microbatches"] = m
        sub = build_cell(cut, cell.shape, cell.mesh, shape=shape, **kw)
        return trace_cost(sub.fn, *sub.arg_specs, fake_mode=sub.fake_mode)

    def full_length(r: int, m: int) -> Cost:
        rows = micro if cell.kind == "train" else micro * m
        ts = cut_lengths(cfg, rows, T) if extend_t else None
        if ts is None:
            return at(r, m, T)
        return _in_length(lambda t: at(r, m, t), cfg, ts, T)

    if cell.kind != "train" or nm == 1:
        return _linear(lambda r: full_length(r, nm), repeat, 1)
    return _linear(lambda r: _linear(lambda m: full_length(r, m), nm, 2),
                   repeat, 1)
