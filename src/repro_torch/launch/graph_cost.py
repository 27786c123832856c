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
* **Collective bytes**: 0 on one card; the field waits for the mesh of
  ROADMAP D3.

Repetition.  JAX's layers are one ``lax.scan`` and its microbatches
another, and its model multiplies a ``while`` body by its trip count.
The port's Python loops unroll, so :func:`cell_cost` traces a cell at
one and two units of its repeated layer pattern (and, for a train
step, at two and three microbatches) and extends the count linearly
(bilinearly for train) to the cell's own depth and microbatch count.
Every term is linear in each: the units are identical, the optimizer's
and the cache's work scale with the stacked leaves.
``tests/test_torch_cost_extension.py`` holds the extended count equal
to the full trace's at 3 pattern units of every layer family (GQA and
MLA attention, dense and MoE feed-forwards, deepseek's dense first
layer, jamba's mamba/MoE pattern, RWKV) at a reduced size.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

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
    mem_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o: "Cost") -> "Cost":
        by = {k: dict(v) for k, v in self.coll_by_op.items()}
        for k, v in o.coll_by_op.items():
            d = by.setdefault(k, {"bytes": 0.0, "count": 0.0})
            d["bytes"] += v["bytes"]
            d["count"] += v["count"]
        dt = dict(self.flops_by_dtype)
        for k, v in o.flops_by_dtype.items():
            dt[k] = dt.get(k, 0.0) + v
        return Cost(self.flops + o.flops, self.mem_bytes + o.mem_bytes,
                    self.coll_bytes + o.coll_bytes, by, dt)

    def scaled(self, k: float) -> "Cost":
        by = {op: {"bytes": v["bytes"] * k, "count": v["count"] * k}
              for op, v in self.coll_by_op.items()}
        return Cost(self.flops * k, self.mem_bytes * k,
                    self.coll_bytes * k, by,
                    {d: v * k for d, v in self.flops_by_dtype.items()})

    def add_flops(self, n: float, dtype: torch.dtype) -> None:
        self.flops += n
        key = str(dtype).removeprefix("torch.")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n

    def __sub__(self, o: "Cost") -> "Cost":
        return self + o.scaled(-1.0)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def _left(packet, args):
    """A product's left matrix operand (``addmm``, ``baddbmm`` and
    ``addmv`` carry the bias first)."""
    return args[1] if packet in (aten.addmm, aten.baddbmm, aten.addmv) \
        else args[0]


class CostMode(TorchDispatchMode):
    """Counts :class:`Cost` over every aten operation dispatched inside
    it; run it inside the avatars' ``FakeTensorMode``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        c = self.cost
        if packet in _MATMULS:
            # the result's elements times twice the contracted size
            a = _left(packet, args)
            c.add_flops(2.0 * out.numel() * a.shape[-1], a.dtype)
        elif packet in flop_registry:
            c.add_flops(float(flop_registry[packet](
                *args, **kwargs, out_val=out)), args[0].dtype)
        outs = _tensors(out)
        if func.is_view or packet in _ALLOCS or not outs:
            return out      # a view, an allocation or a query
        ins = _tensors((args, kwargs))
        if packet in _ROW_UPDATES:
            c.mem_bytes += sum(_nbytes(x) for x in ins[1:]) + sum(
                _nbytes(x) for x in ins[-1:])
        elif packet is aten.copy_:
            c.mem_bytes += _nbytes(args[0]) + _nbytes(args[1])
        elif packet in _GATHERS:
            got = sum(_nbytes(x) for x in outs)
            c.mem_bytes += (min(_nbytes(ins[0]), got)
                            + sum(_nbytes(x) for x in ins[1:]) + got)
        else:
            c.mem_bytes += (sum(_nbytes(x) for x in ins)
                            + sum(_nbytes(x) for x in outs))
        return out


def trace_cost(fn, *args, fake_mode=None, **kwargs) -> Cost:
    """The :class:`Cost` of one call ``fn(*args, **kwargs)`` on fake
    tensors (inside ``fake_mode``, the avatars' mode, when given)."""
    mode = CostMode()
    with (fake_mode if fake_mode is not None else contextlib.nullcontext()):
        with mode:
            fn(*args, **kwargs)
    return mode.cost


def _linear(cost_at, n: int, n0: int) -> Cost:
    """``cost(n)`` of a cost linear in ``n``, from traces at ``n0`` and
    ``n0 + 1``."""
    c0 = cost_at(n0)
    if n == n0:
        return c0
    return c0 + (cost_at(n0 + 1) - c0).scaled(n - n0)


def cell_cost(cell) -> Cost:
    """The cost of a :class:`~repro_torch.launch.specs.CellSpec` at its
    own depth and microbatch count, from traces of the same cell cut to
    one and two units of its repeated pattern (two and three
    microbatches of the same size for a train step): exact where every
    term is linear in each, as the module docstring argues."""
    from repro_torch.launch.specs import build_cell

    cfg = cell.cfg
    pattern_len = len(cfg.block_pattern)
    extra = len(cfg.first_layer_pattern or ())
    repeat = (cfg.num_layers - extra) // pattern_len
    nm = cell.static_info.get("num_microbatches", 1)
    micro = cell.shape_spec["global_batch"] // nm

    def at(r: int, m: int) -> Cost:
        cut = dataclasses.replace(cfg, num_layers=extra + pattern_len * r)
        shape = dict(cell.shape_spec, global_batch=micro * m)
        kw = dict(cell.build_kw)
        if cell.kind == "train":
            kw["num_microbatches"] = m
        sub = build_cell(cut, cell.shape, shape=shape, **kw)
        return trace_cost(sub.fn, *sub.arg_specs, fake_mode=sub.fake_mode)

    if cell.kind != "train" or nm == 1:
        return _linear(lambda r: at(r, nm), repeat, 1)
    return _linear(lambda r: _linear(lambda m: at(r, m), nm, 2), repeat, 1)
