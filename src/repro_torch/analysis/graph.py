"""Event-flow graph extraction for :class:`repro_torch.core.program.
SimProgram` (PyTorch port of :mod:`repro.analysis.graph`).

Each registered handler is traced ONCE into an aten graph,
``make_fx(functionalize(fn), tracing_mode="fake")``, on the portable
emit-row layout: fake CPU tensors of the template's shapes and dtypes,
so no event ever executes and no tensor of the template is read or
touched (a template on the card traces as one on the CPU does).
Functionalization turns the handlers' in-place row writes
(``emits[r, c] = ...``) into ``select_scatter`` and their in-place
state updates into a trailing ``copy_`` on the input.  The graph is
then run through the interval interpreter
(:mod:`repro_torch.analysis.absint`) with every input unknown.  The
emit array's interval reads off, per row:

``[r, 0]``  delay bounds      (lookahead soundness, edge labels)
``[r, 1]``  type bounds       (which event types row ``r`` can emit,
                               whether it can be a ν/no-op row)
``[r, 2]``  arg[0] bounds     (the sharded routing key)

A row whose type upper bound is provably negative is a pure ν row; a
row whose type interval crosses zero is *conditional* (may be ν); a row
whose type upper bound is unbounded emits edges to every type and is
flagged ``may_emit_any``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.analysis.absint import Ival, eval_graph_ivals, unknown_ival
from repro_torch.core.events import ARG_WIDTH


@dataclasses.dataclass(frozen=True)
class EmitEdge:
    """One (handler row → event type) emission possibility."""

    src: str
    row: int
    dst: int          # destination type_id; -1 means "any type"
    dst_name: str
    delay_lo: float
    delay_hi: float
    arg0_lo: float
    arg0_hi: float
    conditional: bool  # the row's type interval crosses 0: may be ν

    @property
    def delay_known(self) -> bool:
        return (math.isfinite(self.delay_lo)
                and self.delay_lo == self.delay_hi)


@dataclasses.dataclass
class HandlerNode:
    """Static summary of one registered handler."""

    name: str
    type_id: int
    lookahead: float
    emits: bool
    entity: bool
    edges: list[EmitEdge] = dataclasses.field(default_factory=list)
    nu_rows: tuple[int, ...] = ()
    may_emit_any: bool = False
    arg_used: bool = False
    trace_error: str | None = None
    emits_shape: tuple | None = None
    emits_dtype: str | None = None
    # raw per-row (delay_lo, delay_hi, type_lo, type_hi, a0_lo, a0_hi)
    row_bounds: tuple[tuple[float, ...], ...] = ()

    @property
    def min_delay_lo(self) -> float:
        """Provable lower bound on this handler's min emission delay
        over all non-ν rows (+inf when it cannot emit)."""
        if not self.edges:
            return float("inf")
        return min(e.delay_lo for e in self.edges)


@dataclasses.dataclass(frozen=True)
class Traced:
    """One handler's trace: the aten graph and what it returned (whether
    it was a ``(state, emits)`` pair, the emits' leaf count, and the
    last leaf's shape and dtype)."""

    gm: torch.fx.GraphModule
    pair: bool
    kind: str
    emit_leaves: int
    emits_shape: tuple | None
    emits_dtype: str | None


def _leaf_template(x) -> torch.Tensor:
    """An uninitialized CPU tensor of a state leaf's shape and dtype
    (uint32 arrays as the int64 the port carries them in)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.empty(a.shape, dtype=torch.from_numpy(
        np.zeros((), a.dtype)).dtype)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _entity_template(x) -> torch.Tensor:
    t = _leaf_template(x)
    return torch.empty(tuple(t.shape[1:]), dtype=t.dtype)


def _summary(out) -> dict:
    """What a handler returned, read inside the trace (its tensors are
    the tracer's and must not leave it)."""
    if not (isinstance(out, tuple) and len(out) == 2):
        return dict(pair=False, kind=type(out).__name__, emit_leaves=0,
                    emits_shape=None, emits_dtype=None)
    leaves = _tree_leaves(out[1])
    last = leaves[-1] if leaves else None
    tensor = isinstance(last, torch.Tensor)
    return dict(pair=True, kind="tuple", emit_leaves=len(leaves),
                emits_shape=tuple(last.shape) if tensor else None,
                emits_dtype=(str(last.dtype).removeprefix("torch.")
                             if tensor else None))


def trace_handler(spec, state, max_emit: int):
    """``(Traced, None) | (None, error_message)`` for one handler spec,
    traced on the portable layout."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.tree import tree_map

    t_in = torch.empty((), dtype=torch.float32)
    arg_in = torch.empty((ARG_WIDTH,), dtype=torch.float32)
    try:
        if spec.entity:
            leaves = _tree_leaves(state)
            if any(np.ndim(leaf) < 1 for leaf in leaves):
                return None, (
                    "entity handler needs every state leaf to carry the "
                    "entity dimension on axis 0; got a scalar leaf")
            state_in = tree_map(_entity_template, state)
        else:
            state_in = tree_map(_leaf_template, state)
        seen = {}
        fn = spec.fn

        def body(state, t, arg):
            out = fn(state, t, arg)
            seen.update(_summary(out))
            return out

        gm = make_fx(torch.func.functionalize(
            body, remove="mutations_and_views"),
            tracing_mode="fake", _allow_non_fake_inputs=True)(
                state_in, t_in, arg_in)
        return Traced(gm=gm, **seen), None
    except Exception as exc:  # surface as a finding, not a crash
        return None, f"{type(exc).__name__}: {exc}"


def _placeholders(gm) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def _emits_ival(traced: Traced, max_emit: int):
    """Run the interval interpreter; return (emits Ival, problem | None).

    The portable contract is ``(state, emits)``; emits must be the
    single leaf of the second element."""
    if not traced.pair:
        return None, (
            "emitting handler must return a (state, emits) pair; got "
            f"{traced.kind}")
    if traced.emit_leaves != 1:
        return None, (
            f"emits must be a single array, got {traced.emit_leaves} "
            "leaves")
    in_ivals = []
    for node in _placeholders(traced.gm):
        val = node.meta["val"]
        in_ivals.append(unknown_ival(tuple(val.shape), val.dtype))
    try:
        outs = eval_graph_ivals(traced.gm, in_ivals)
    except Exception as exc:
        return None, f"interval interpretation failed: {exc}"
    emits = outs[-1]  # out tree is (state..., emits): emits last
    if not isinstance(emits, Ival):
        return None, "emits is not a tensor"
    return emits, None


def _arg_used(traced: Traced) -> bool:
    nodes = _placeholders(traced.gm)
    return bool(nodes) and bool(nodes[-1].users)


def extract_node(spec, state, max_emit: int, names: list[str],
                 traced=None) -> HandlerNode:
    """One handler's :class:`HandlerNode`; ``traced`` reuses a trace
    already made (a :func:`trace_handler` result)."""
    node = HandlerNode(
        name=spec.name, type_id=spec.type_id,
        lookahead=float(spec.lookahead),
        emits=bool(spec.emits), entity=bool(spec.entity),
    )
    if traced is None:
        traced = trace_handler(spec, state, max_emit)
    traced, err = traced
    if traced is None:
        node.trace_error = err
        return node
    node.arg_used = _arg_used(traced)
    if not spec.emits:
        return node

    if traced.emits_shape is not None:
        node.emits_shape = traced.emits_shape
        node.emits_dtype = traced.emits_dtype

    emits_iv, problem = _emits_ival(traced, max_emit)
    if problem is not None:
        node.trace_error = problem
        return node
    if emits_iv.lo.ndim != 2 or emits_iv.lo.shape[1] < 3:
        node.trace_error = (
            f"emits rows must be 2-D (delay, type, arg...); got shape "
            f"{emits_iv.lo.shape}")
        return node

    T = len(names)
    edges, nu_rows, bounds = [], [], []
    for r in range(emits_iv.lo.shape[0]):
        d_lo, d_hi = float(emits_iv.lo[r, 0]), float(emits_iv.hi[r, 0])
        t_lo, t_hi = float(emits_iv.lo[r, 1]), float(emits_iv.hi[r, 1])
        a_lo, a_hi = float(emits_iv.lo[r, 2]), float(emits_iv.hi[r, 2])
        bounds.append((d_lo, d_hi, t_lo, t_hi, a_lo, a_hi))
        if t_hi < 0:
            nu_rows.append(r)
            continue
        conditional = t_lo < 0
        if math.isinf(t_hi):
            node.may_emit_any = True
            for dst in range(T):
                edges.append(EmitEdge(
                    src=spec.name, row=r, dst=dst, dst_name=names[dst],
                    delay_lo=d_lo, delay_hi=d_hi,
                    arg0_lo=a_lo, arg0_hi=a_hi, conditional=True,
                ))
            continue
        lo_id = max(int(math.ceil(t_lo)), 0)
        hi_id = min(int(math.floor(t_hi)), T - 1)
        for dst in range(lo_id, hi_id + 1):
            edges.append(EmitEdge(
                src=spec.name, row=r, dst=dst, dst_name=names[dst],
                delay_lo=d_lo, delay_hi=d_hi,
                arg0_lo=a_lo, arg0_hi=a_hi,
                conditional=conditional or lo_id != hi_id,
            ))
    node.edges = edges
    node.nu_rows = tuple(nu_rows)
    node.row_bounds = tuple(bounds)
    return node


def extract_graph(prog, state, traces: dict | None = None
                  ) -> dict[str, HandlerNode]:
    """name -> HandlerNode for every registered handler; ``traces``,
    when given, receives each handler's trace (for the purity pass)."""
    names = list(prog.names)
    out = {}
    for spec in prog._specs:
        traced = trace_handler(spec, state, prog.config.max_emit)
        if traces is not None:
            traces[spec.name] = traced
        out[spec.name] = extract_node(spec, state, prog.config.max_emit,
                                      names, traced=traced)
    return out
