"""Interval abstract interpretation over aten graphs (PyTorch port).

Counterpart of :mod:`repro.analysis.absint`.  The static analyzer needs
*bounds* on the values a handler writes into its portable emit rows:
the delay column decides lookahead soundness, the type column the
event-flow edges, and ``arg[0]`` is the sharded routing key.  Those
cells are built from constants, hashes folded through ``% k`` and
``torch.where`` gates, so a per-element interval domain recovers them
exactly in the common case while degrading soundly to *unknown* when a
value is genuinely data-dependent.

The domain is the JAX package's: every graph value is an :class:`Ival`,
a pair of float64 numpy arrays ``(lo, hi)`` of the value's shape,
meaning "each element lies in [lo, hi]".  ``(-inf, +inf)`` is unknown;
``lo == hi`` is a known constant; booleans are 0/1 intervals.  The
graph is a ``torch.fx.Graph`` of aten ops (``make_fx`` over a
functionalized handler, :mod:`repro_torch.analysis.graph`), and each
node's ``meta["val"]`` gives its shape and dtype:

* a placeholder takes its input interval, a ``get_attr`` constant is a
  known interval, and a plain Python argument (the ``.Scalar``
  overloads' numbers) is a constant;
* if every input of a node is known, the aten op is *executed* on CPU
  tensors, an exact constant fold that does not depend on the device of
  the template the handler was traced against;
* otherwise a per-op transfer rule propagates intervals; structural ops
  (select, slice, cat, ``select_scatter`` with known indices) are
  emulated positionally on the lo and hi arrays, which keeps emit rows
  written cell by cell (``emits[r, c] = ...``) precise per cell;
* an op without a rule is unknown: the analysis never invents a bound.

Integer soundness: after every node the result is checked against the
output dtype's range, and a bound that escapes it (possible wraparound)
widens to the whole range instead of being clipped.  Integer ``&``
with a non-negative operand, ``>>`` and ``^`` keep the int64-carried
u32 hashes of the port's models (``(x * c) & 0xFFFFFFFF``) in
``[0, 2^32)``.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import NamedTuple

import numpy as np
import torch

_NEG_INF = float("-inf")
_POS_INF = float("inf")

# Exact-integer ceiling for the float64 carrier: integer constants
# above this are not exactly representable, so they degrade to unknown
# rather than silently rounding.
_EXACT_INT_MAX = float(2**53)


class Ival(NamedTuple):
    """Per-element interval: two float64 arrays of the value's shape."""

    lo: np.ndarray
    hi: np.ndarray

    @property
    def known(self) -> bool:
        """True when every element is pinned to a single value."""
        return bool(np.all(self.lo == self.hi))


def const_ival(x) -> Ival:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype.is_floating_point and x.dtype != torch.float64:
            x = x.to(torch.float64)
        x = x.numpy()
    a = np.asarray(x)
    integer = np.issubdtype(a.dtype, np.integer)
    f = np.asarray(a, np.float64)
    if f.size and integer:
        if float(np.max(np.abs(f), initial=0.0)) > _EXACT_INT_MAX:
            return Ival(np.full(f.shape, _NEG_INF),
                        np.full(f.shape, _POS_INF))
    return Ival(f, f.copy())


def _dtype_range(dtype) -> tuple[float, float]:
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return 0.0, 1.0
        if dtype.is_floating_point or dtype.is_complex:
            return _NEG_INF, _POS_INF
        info = torch.iinfo(dtype)
        return float(info.min), float(info.max)
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return 0.0, 1.0
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return float(info.min), float(info.max)
    return _NEG_INF, _POS_INF


def _is_int(dtype) -> bool:
    return not (dtype == torch.bool or dtype.is_floating_point
                or dtype.is_complex)


def unknown_ival(shape, dtype) -> Ival:
    lo, hi = _dtype_range(dtype)
    shape = tuple(shape)
    return Ival(np.full(shape, lo), np.full(shape, hi))


def _guard(iv: Ival, shape, dtype) -> Ival:
    """Sound dtype post-condition: any element whose bound escapes the
    output dtype's range may have wrapped: widen IT (not clip it) to
    the full range.  NaN bounds also widen."""
    lo_d, hi_d = _dtype_range(dtype)
    lo = np.broadcast_to(np.asarray(iv.lo, np.float64), tuple(shape)).copy()
    hi = np.broadcast_to(np.asarray(iv.hi, np.float64), tuple(shape)).copy()
    bad = np.isnan(lo) | np.isnan(hi) | (lo > hi)
    if math.isfinite(lo_d):  # integer / bool dtype
        bad |= (lo < lo_d) | (hi > hi_d)
    lo[bad] = lo_d
    hi[bad] = hi_d
    return Ival(lo, hi)


def _hull(*ivs: Ival) -> Ival:
    lo = ivs[0].lo
    hi = ivs[0].hi
    for iv in ivs[1:]:
        lo = np.minimum(lo, iv.lo)
        hi = np.maximum(hi, iv.hi)
    return Ival(lo, hi)


def hull_scalar(iv: Ival, shape) -> Ival:
    """Collapse to the global [min, max] of the array, broadcast to
    ``shape``: the sound fallback for data-dependent indexing."""
    lo = float(np.min(iv.lo)) if iv.lo.size else _NEG_INF
    hi = float(np.max(iv.hi)) if iv.hi.size else _POS_INF
    return Ival(np.full(tuple(shape), lo), np.full(tuple(shape), hi))


# ---------------------------------------------------------------------------
# transfer functions
# ---------------------------------------------------------------------------

def _mul_iv(a: Ival, b: Ival) -> Ival:
    with np.errstate(all="ignore"):
        prods = np.stack(np.broadcast_arrays(
            a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi))
    bad = np.isnan(prods).any(axis=0)
    lo = np.where(bad, _NEG_INF,
                  np.min(np.where(np.isnan(prods), _POS_INF, prods), axis=0))
    hi = np.where(bad, _POS_INF,
                  np.max(np.where(np.isnan(prods), _NEG_INF, prods), axis=0))
    return Ival(lo, hi)


def _div_iv(a: Ival, b: Ival, *, integer: bool) -> Ival:
    # Divisor interval touching 0 -> unknown.
    crosses = (b.lo <= 0) & (b.hi >= 0)
    with np.errstate(all="ignore"):
        qs = np.stack(np.broadcast_arrays(
            a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi))
    bad = np.isnan(qs).any(axis=0) | np.broadcast_to(crosses, qs.shape[1:])
    lo = np.where(bad, _NEG_INF,
                  np.min(np.where(np.isnan(qs), _POS_INF, qs), axis=0))
    hi = np.where(bad, _POS_INF,
                  np.max(np.where(np.isnan(qs), _NEG_INF, qs), axis=0))
    if integer:  # a rounded quotient lies within [floor, ceil]
        with np.errstate(invalid="ignore"):
            lo = np.floor(lo)
            hi = np.ceil(hi)
    return Ival(lo, hi)


def _rem_iv(a: Ival, b: Ival, *, integer: bool, pymod: bool) -> Ival:
    """C-style remainder (``fmod``: the dividend's sign) or Python-style
    mod (``remainder``: the divisor's sign).

    Sound whenever the divisor is bounded; exactness needs a positive
    divisor bound.  The dividend may be completely unknown: that is the
    whole point (hash % k)."""
    d_hi = np.maximum(np.abs(b.lo), np.abs(b.hi))
    pos = b.lo > 0
    bounded = np.isfinite(d_hi)
    mag = np.where(bounded, d_hi - (1.0 if integer else 0.0), _POS_INF)
    mag = np.maximum(mag, 0.0)
    if pymod:
        # result sign follows the divisor; positive divisor -> [0, d).
        lo = np.where(pos & bounded, 0.0, -np.where(bounded, mag, _POS_INF))
        hi = np.where(bounded, mag, _POS_INF)
    else:
        nonneg_dividend = a.lo >= 0
        lo = np.where(nonneg_dividend, 0.0,
                      -np.where(bounded, mag, _POS_INF))
        hi = np.where(bounded, mag, _POS_INF)
    lo, hi = np.broadcast_arrays(*np.broadcast_arrays(lo, hi, a.lo)[:2])
    return Ival(np.asarray(lo, np.float64).copy(),
                np.asarray(hi, np.float64).copy())


def _cmp(a: Ival, b: Ival, op: str) -> Ival:
    one = np.float64(1.0)
    zero = np.float64(0.0)
    if op == "lt":
        t, f = a.hi < b.lo, a.lo >= b.hi
    elif op == "le":
        t, f = a.hi <= b.lo, a.lo > b.hi
    elif op == "gt":
        t, f = a.lo > b.hi, a.hi <= b.lo
    elif op == "ge":
        t, f = a.lo >= b.hi, a.hi < b.lo
    elif op == "eq":
        t = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
        f = (a.hi < b.lo) | (a.lo > b.hi)
    else:  # ne
        f = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
        t = (a.hi < b.lo) | (a.lo > b.hi)
    t, f = np.broadcast_arrays(t, f)
    lo = np.where(t, one, zero)
    hi = np.where(f, zero, one)
    return Ival(lo, hi)


def _select_n(pred: Ival, cases: list[Ival], out_shape) -> Ival:
    if pred.known:
        idx = pred.lo.astype(np.int64)
        lo = np.zeros(tuple(out_shape))
        hi = np.zeros(tuple(out_shape))
        idx_b = np.broadcast_to(idx, tuple(out_shape))
        for i, c in enumerate(cases):
            sel = idx_b == i
            lo = np.where(sel, np.broadcast_to(c.lo, tuple(out_shape)), lo)
            hi = np.where(sel, np.broadcast_to(c.hi, tuple(out_shape)), hi)
        return Ival(lo, hi)
    lo = np.broadcast_to(cases[0].lo, tuple(out_shape)).astype(np.float64)
    hi = np.broadcast_to(cases[0].hi, tuple(out_shape)).astype(np.float64)
    for c in cases[1:]:
        lo = np.minimum(lo, np.broadcast_to(c.lo, tuple(out_shape)))
        hi = np.maximum(hi, np.broadcast_to(c.hi, tuple(out_shape)))
    return Ival(lo, hi)


def _broadcast_in_dim(x: Ival, shape, broadcast_dimensions) -> Ival:
    def expand(a):
        newshape = [1] * len(shape)
        for src, dst in enumerate(broadcast_dimensions):
            newshape[dst] = a.shape[src]
        return np.broadcast_to(np.reshape(a, newshape), tuple(shape))
    return Ival(expand(x.lo), expand(x.hi))


def _scatter_points(op: Ival, pts: np.ndarray, upd: Ival, *,
                    add: bool) -> Ival | None:
    """Emulate a scatter of scalar updates (``upd``: ``[P]`` or a
    scalar) at KNOWN full-rank points (``pts: int[P, rank]``, negative
    coordinates already wrapped):
    ``x.index_put_((i, j), v)`` and its ``accumulate=True`` form.
    Out-of-range points drop, as JAX's scatter drops them.  Returns None
    when a set scatter hits a point twice (order-dependent)."""
    upd_lo = np.broadcast_to(upd.lo, pts.shape[:1])
    upd_hi = np.broadcast_to(upd.hi, pts.shape[:1])
    if not add and len({tuple(p) for p in pts.tolist()}) != pts.shape[0]:
        return None
    lo = op.lo.copy()
    hi = op.hi.copy()
    shape = op.lo.shape
    for p in range(pts.shape[0]):
        coord = tuple(int(c) for c in pts[p])
        if not all(0 <= c < n for c, n in zip(coord, shape)):
            continue
        if add:
            lo[coord] += upd_lo[p]
            hi[coord] += upd_hi[p]
        else:
            lo[coord] = upd_lo[p]
            hi[coord] = upd_hi[p]
    return Ival(lo, hi)


def _pow2_ceiling(hi: np.ndarray) -> np.ndarray:
    """The least ``2^k - 1 >= hi`` for ``hi >= 0``: every value in
    ``[0, hi]`` has its bits inside the low ``k``."""
    with np.errstate(all="ignore"):
        k = np.floor(np.log2(np.maximum(hi, 1.0))) + 1.0
    return np.exp2(k) - 1.0


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

class _Opaque:
    """A graph value the domain does not model (not a tensor)."""


_OPAQUE = _Opaque()

# Creation ops whose result does not depend on their inputs' values:
# executing them would invent values (uninitialized memory, a random
# draw), so they are never folded.
_NEVER_EXECUTE = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "_local_scalar_dense")


def _spec(val):
    """``(shape, dtype)`` of a traced value, a list of them for a node
    with several outputs, None for a value that is not a tensor."""
    if isinstance(val, torch.Tensor):
        return tuple(val.shape), val.dtype
    if isinstance(val, (list, tuple)):
        return [_spec(v) for v in val]
    return None


def _fit(iv, spec):
    """Guard a rule's or a fold's result against its node's spec (None,
    or a result of the wrong form, is unknown)."""
    if spec is None:
        return _OPAQUE
    if isinstance(spec, list):
        if not isinstance(iv, (list, tuple)) or len(iv) != len(spec):
            return _unknown(spec)
        return [_fit(v, s) for v, s in zip(iv, spec)]
    if not isinstance(iv, Ival):
        return unknown_ival(*spec)
    return _guard(iv, *spec)


def _unknown(spec):
    if spec is None:
        return _OPAQUE
    if isinstance(spec, list):
        return [_unknown(s) for s in spec]
    return unknown_ival(*spec)


def _attr(gm, target: str):
    return functools.reduce(getattr, target.split("."), gm)


def _resolve(x, env):
    if isinstance(x, torch.fx.Node):
        return env[x]
    if isinstance(x, (list, tuple)):
        return type(x)(_resolve(v, env) for v in x)
    if isinstance(x, dict):
        return {k: _resolve(v, env) for k, v in x.items()}
    return x


def _nodes_in(x):
    if isinstance(x, torch.fx.Node):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _nodes_in(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _nodes_in(v)


def _node_spec(node, gm):
    if "val" in node.meta:
        return _spec(node.meta["val"])
    if node.op == "get_attr":
        return _spec(_attr(gm, node.target))
    return None


def _executable(target) -> bool:
    packet = getattr(target, "overloadpacket", None)
    if packet is None:
        return False
    if packet.__name__ in _NEVER_EXECUTE:
        return False
    return torch.Tag.nondeterministic_seeded not in target.tags


def _try_exact(node, env, gm):
    """All inputs known -> run the aten op on CPU tensors for an exact
    result; None when it cannot run (or an input is too large to carry
    exactly)."""

    def tensor(x):
        iv = env[x]
        shape, dtype = _node_spec(x, gm)
        if _is_int(dtype) and iv.lo.size and float(
                np.max(np.abs(iv.lo), initial=0.0)) > _EXACT_INT_MAX:
            raise OverflowError
        t = torch.from_numpy(np.ascontiguousarray(iv.lo, np.float64))
        if _is_int(dtype):
            t = t.to(torch.int64)
        return t.to(dtype).reshape(shape)

    def build(x):
        if isinstance(x, torch.fx.Node):
            return tensor(x)
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if isinstance(x, torch.device):
            return torch.device("cpu")
        return x

    try:
        args = build(node.args)
        kwargs = {k: build(v) for k, v in node.kwargs.items()}
        if "device" in kwargs:
            kwargs["device"] = torch.device("cpu")
        if kwargs.get("pin_memory"):
            kwargs["pin_memory"] = False
        out = node.target(*args, **kwargs)
    except Exception:
        return None
    if isinstance(out, torch.Tensor):
        return const_ival(out)
    if isinstance(out, (list, tuple)):
        return [const_ival(o) if isinstance(o, torch.Tensor) else None
                for o in out]
    return None


def _constant(value):
    """A closed-over tensor's interval: known when its values can be
    read (a tensor on the card is copied to the host; one without data,
    on the meta device, is unknown)."""
    if not isinstance(value, torch.Tensor):
        return None
    try:
        return const_ival(value)
    except Exception:
        return None


def eval_graph_ivals(gm, in_ivals: list[Ival]) -> list:
    """Interpret a traced ``torch.fx.GraphModule`` over the interval
    domain: one :class:`Ival` per placeholder in, the flattened output
    list out (a value the domain does not model comes out unknown)."""
    env: dict = {}
    inputs = iter(in_ivals)
    for node in gm.graph.nodes:
        spec = _node_spec(node, gm)
        if node.op == "placeholder":
            out = next(inputs)
        elif node.op == "get_attr":
            out = _constant(_attr(gm, node.target))
        elif node.op == "call_function":
            out = _eval_call(node, env, gm, spec)
        elif node.op == "output":
            flat = list(_nodes_in(node.args[0]))
            return [env[x] if isinstance(env[x], Ival) else
                    _unknown(_node_spec(x, gm)) for x in flat]
        else:
            out = None
        env[node] = out if out is _OPAQUE else _fit(out, spec)
    raise ValueError("graph has no output node")


def _eval_call(node, env, gm, spec):
    if node.target is operator.getitem:
        seq, i = node.args
        v = env[seq]
        return v[i] if isinstance(v, (list, tuple)) else None
    ins = [env[x] for x in _nodes_in((node.args, node.kwargs))]
    if any(not isinstance(iv, Ival) for iv in ins):
        return None
    if all(iv.known for iv in ins) and _executable(node.target):
        out = _try_exact(node, env, gm)
        if out is not None:
            return out
    packet = getattr(node.target, "overloadpacket", None)
    rule = _RULES.get(packet.__name__) if packet is not None else None
    if rule is None:
        return None
    args = _resolve(node.args, env)
    kwargs = _resolve(node.kwargs, env)
    try:
        return rule(node, args, kwargs, spec, gm)
    except Exception:  # a malformed case of a rule: sound fallback
        return None


# ---------------------------------------------------------------------------
# transfer rules, keyed by the aten op's name (every overload)
# ---------------------------------------------------------------------------

_RULES: dict = {}


def _rule(*names):
    def wrap(fn):
        for name in names:
            _RULES[name] = fn
        return fn
    return wrap


def _iv(x) -> Ival:
    """An operand as an interval: a Python number is a constant."""
    if isinstance(x, Ival):
        return x
    return const_ival(np.float64(float(x)))


def _in_spec(node, i, gm):
    return _node_spec(node.args[i], gm)


def _alpha(b: Ival, kwargs) -> Ival:
    alpha = kwargs.get("alpha", 1)
    return b if alpha == 1 else _mul_iv(b, _iv(alpha))


@_rule("add")
def _add(node, args, kwargs, spec, gm):
    a, b = _iv(args[0]), _alpha(_iv(args[1]), kwargs)
    return Ival(a.lo + b.lo, a.hi + b.hi)


@_rule("sub")
def _sub(node, args, kwargs, spec, gm):
    a, b = _iv(args[0]), _alpha(_iv(args[1]), kwargs)
    return Ival(a.lo - b.hi, a.hi - b.lo)


@_rule("rsub")
def _rsub(node, args, kwargs, spec, gm):
    a, b = _alpha(_iv(args[0]), kwargs), _iv(args[1])
    return Ival(b.lo - a.hi, b.hi - a.lo)


@_rule("mul")
def _mul(node, args, kwargs, spec, gm):
    return _mul_iv(_iv(args[0]), _iv(args[1]))


@_rule("div", "floor_divide")
def _div(node, args, kwargs, spec, gm):
    q = _div_iv(_iv(args[0]), _iv(args[1]), integer=False)
    mode = ("floor" if node.target.overloadpacket.__name__ == "floor_divide"
            else kwargs.get("rounding_mode"))
    if mode is None:
        return q
    f = np.floor if mode == "floor" else np.trunc  # both monotone
    with np.errstate(invalid="ignore"):
        return Ival(f(q.lo), f(q.hi))


@_rule("remainder", "fmod")
def _remainder(node, args, kwargs, spec, gm):
    return _rem_iv(_iv(args[0]), _iv(args[1]), integer=_is_int(spec[1]),
                   pymod=node.target.overloadpacket.__name__ == "remainder")


@_rule("neg")
def _neg(node, args, kwargs, spec, gm):
    return Ival(-args[0].hi, -args[0].lo)


@_rule("abs")
def _abs(node, args, kwargs, spec, gm):
    x = args[0]
    spans = (x.lo <= 0) & (x.hi >= 0)
    lo = np.where(spans, 0.0, np.minimum(np.abs(x.lo), np.abs(x.hi)))
    return Ival(lo, np.maximum(np.abs(x.lo), np.abs(x.hi)))


@_rule("sign", "sgn")
def _sign(node, args, kwargs, spec, gm):
    return Ival(np.sign(args[0].lo), np.sign(args[0].hi))


@_rule("maximum", "minimum", "fmax", "fmin")
def _maxmin(node, args, kwargs, spec, gm):
    f = (np.maximum if node.target.overloadpacket.__name__
         in ("maximum", "fmax") else np.minimum)
    a, b = _iv(args[0]), _iv(args[1])
    return Ival(f(a.lo, b.lo), f(a.hi, b.hi))


@_rule("clamp", "clamp_min", "clamp_max")
def _clamp(node, args, kwargs, spec, gm):
    name = node.target.overloadpacket.__name__
    x = args[0]
    lo_b = hi_b = None
    if name == "clamp":
        rest = list(args[1:]) + [None, None]
        lo_b = kwargs.get("min", rest[0])
        hi_b = kwargs.get("max", rest[1])
    elif name == "clamp_min":
        lo_b = args[1]
    else:
        hi_b = args[1]
    lo, hi = x.lo, x.hi
    if lo_b is not None:  # monotone in every argument
        m = _iv(lo_b)
        lo, hi = np.maximum(lo, m.lo), np.maximum(hi, m.hi)
    if hi_b is not None:
        m = _iv(hi_b)
        lo, hi = np.minimum(lo, m.lo), np.minimum(hi, m.hi)
    return Ival(lo, hi)


_MONOTONE = {
    "floor": np.floor, "ceil": np.ceil, "round": np.round,
    "trunc": np.trunc, "exp": np.exp, "exp2": np.exp2, "tanh": np.tanh,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "sqrt": lambda x: np.sqrt(np.maximum(x, 0.0)),
    "log": lambda x: np.log(np.maximum(x, 0.0)),
    "log2": lambda x: np.log2(np.maximum(x, 0.0)),
    "log1p": lambda x: np.log1p(np.maximum(x, -1.0)),
    "expm1": np.expm1,
}


@_rule(*_MONOTONE)
def _monotone(node, args, kwargs, spec, gm):
    f = _MONOTONE[node.target.overloadpacket.__name__]
    with np.errstate(all="ignore"):
        return Ival(f(args[0].lo), f(args[0].hi))


@_rule("sin", "cos")
def _sincos(node, args, kwargs, spec, gm):
    # Not monotone; known inputs are folded, so the range is all that
    # is needed here.
    return Ival(np.full(spec[0], -1.0), np.full(spec[0], 1.0))


@_rule("pow")
def _pow(node, args, kwargs, spec, gm):
    y = args[1]
    if isinstance(y, Ival) or float(y) != int(y) or y < 0:
        return None
    y = int(y)
    x = args[0]
    lo_p, hi_p = x.lo ** y, x.hi ** y
    if y % 2 == 0:
        spans = (x.lo <= 0) & (x.hi >= 0)
        return Ival(np.where(spans, 0.0, np.minimum(lo_p, hi_p)),
                    np.maximum(lo_p, hi_p))
    return Ival(lo_p, hi_p)


def _convert(x: Ival, src, dst) -> Ival:
    """``x`` cast from dtype ``src`` to ``dst`` (``_guard`` widens a
    value that does not fit)."""
    if dst == torch.bool:
        nz = _cmp(x, const_ival(np.float64(0.0)), "ne")
        return nz
    lo, hi = x.lo, x.hi
    if _is_int(dst) and src is not None and src.is_floating_point:
        with np.errstate(invalid="ignore"):
            lo, hi = np.trunc(lo), np.trunc(hi)  # C-style truncation
    return Ival(lo, hi)


@_rule("_to_copy", "to", "_to_dtype")
def _to_copy(node, args, kwargs, spec, gm):
    src = _in_spec(node, 0, gm)
    return _convert(args[0], None if src is None else src[1], spec[1])


@_rule("clone", "alias", "alias_copy", "lift_fresh_copy", "lift_fresh",
       "detach", "detach_copy", "contiguous", "positive")
def _identity(node, args, kwargs, spec, gm):
    return args[0]


@_rule("copy")
def _copy(node, args, kwargs, spec, gm):
    src = _in_spec(node, 1, gm)
    return _convert(args[1], None if src is None else src[1], spec[1])


@_rule("fill")
def _fill(node, args, kwargs, spec, gm):
    return _convert(_iv(args[1]), torch.float64, spec[1])


@_rule("full_like", "zeros_like", "ones_like", "new_zeros", "new_ones",
       "new_full")
def _const_fill(node, args, kwargs, spec, gm):
    # Creations from a template: the result does not depend on the
    # template's values (creations from sizes alone are folded).
    name = node.target.overloadpacket.__name__
    if name in ("zeros_like", "new_zeros"):
        v = 0.0
    elif name in ("ones_like", "new_ones"):
        v = 1.0
    else:
        v = kwargs.get("fill_value", args[-1])
    return _convert(_iv(v), torch.float64, spec[1])


@_rule("lt", "le", "gt", "ge", "eq", "ne")
def _compare(node, args, kwargs, spec, gm):
    return _cmp(_iv(args[0]), _iv(args[1]),
                node.target.overloadpacket.__name__)


def _truth(x: Ival) -> Ival:
    return _cmp(x, const_ival(np.float64(0.0)), "ne")


@_rule("logical_not", "bitwise_not")
def _not(node, args, kwargs, spec, gm):
    x = args[0]
    if spec[1] == torch.bool:
        x = _truth(x)
        return Ival(1.0 - x.hi, 1.0 - x.lo)
    return Ival(-x.hi - 1.0, -x.lo - 1.0)  # two's complement: ~x = -x - 1


@_rule("bitwise_and", "bitwise_or", "bitwise_xor", "__and__", "__or__",
       "__xor__", "logical_and", "logical_or", "logical_xor")
def _bitwise(node, args, kwargs, spec, gm):
    name = node.target.overloadpacket.__name__.strip("_")
    op = name.split("_")[-1]
    a, b = _iv(args[0]), _iv(args[1])
    shape = np.broadcast_shapes(a.lo.shape, b.lo.shape)
    if spec[1] == torch.bool:
        a, b = _truth(a), _truth(b)
        if op == "and":
            return Ival(a.lo * b.lo, np.minimum(a.hi, b.hi))
        if op == "or":
            return Ival(np.maximum(a.lo, b.lo),
                        np.minimum(1.0, a.hi + b.hi))
        t = (a.lo == a.hi) & (b.lo == b.hi)
        v = np.abs(a.lo - b.lo)
        return Ival(np.where(t, v, 0.0), np.where(t, v, 1.0))
    a_nn, b_nn = a.lo >= 0, b.lo >= 0
    if op == "and":
        # x & c with c >= 0 lies in [0, c] whatever x is: the result's
        # bits are a subset of c's, its sign bit clear.
        hi = np.where(a_nn & b_nn, np.minimum(a.hi, b.hi),
                      np.where(a_nn, a.hi, b.hi))
        lo = np.where(a_nn | b_nn, 0.0, _NEG_INF)
        hi = np.where(a_nn | b_nn, hi, _POS_INF)
        return Ival(np.broadcast_to(lo, shape), np.broadcast_to(hi, shape))
    # or / xor of two non-negatives: no bit above the wider one's top.
    both = a_nn & b_nn
    cap = _pow2_ceiling(np.maximum(a.hi, b.hi))
    hi = np.minimum(a.hi + b.hi, cap)
    lo = np.maximum(a.lo, b.lo) if op == "or" else np.zeros(shape)
    return Ival(np.where(both, lo, _NEG_INF), np.where(both, hi, _POS_INF))


@_rule("__rshift__", "bitwise_right_shift")
def _rshift(node, args, kwargs, spec, gm):
    a, k = _iv(args[0]), _iv(args[1])
    if not k.known:
        return None
    scale = 2.0 ** k.lo  # arithmetic: floor division by 2^k
    with np.errstate(all="ignore"):
        return Ival(np.floor(a.lo / scale), np.floor(a.hi / scale))


@_rule("__lshift__", "bitwise_left_shift")
def _lshift(node, args, kwargs, spec, gm):
    a, k = _iv(args[0]), _iv(args[1])
    if not k.known:
        return None
    return _mul_iv(a, Ival(2.0 ** k.lo, 2.0 ** k.lo))


@_rule("where")
def _where(node, args, kwargs, spec, gm):
    cond, a, b = args[0], _iv(args[1]), _iv(args[2])
    return _select_n(_truth(cond), [b, a], spec[0])


@_rule("masked_fill")
def _masked_fill(node, args, kwargs, spec, gm):
    return _select_n(_truth(args[1]), [args[0], _iv(args[2])], spec[0])


# -- structural ----------------------------------------------------------------

@_rule("view", "view_copy", "reshape", "_unsafe_view", "_reshape_alias",
       "_reshape_alias_copy", "squeeze", "squeeze_copy", "unsqueeze",
       "unsqueeze_copy", "flatten", "unflatten")
def _reshape(node, args, kwargs, spec, gm):
    x = args[0]
    return Ival(x.lo.reshape(spec[0]), x.hi.reshape(spec[0]))


@_rule("expand", "expand_copy", "broadcast_to")
def _expand(node, args, kwargs, spec, gm):
    x = args[0]
    return Ival(np.broadcast_to(x.lo, spec[0]), np.broadcast_to(x.hi, spec[0]))


@_rule("permute", "permute_copy")
def _permute(node, args, kwargs, spec, gm):
    dims = [d % args[0].lo.ndim for d in args[1]]
    return Ival(np.transpose(args[0].lo, dims), np.transpose(args[0].hi, dims))


@_rule("transpose", "transpose_copy", "t", "t_copy")
def _transpose(node, args, kwargs, spec, gm):
    x = args[0]
    d0, d1 = (args[1], args[2]) if len(args) > 2 else (0, -1)
    if x.lo.ndim < 2:
        return x
    return Ival(np.swapaxes(x.lo, d0, d1), np.swapaxes(x.hi, d0, d1))


@_rule("select", "select_copy")
def _select(node, args, kwargs, spec, gm):
    x, dim, index = args[0], args[1], args[2]
    return Ival(np.take(x.lo, index, axis=dim), np.take(x.hi, index, axis=dim))


def _slicer(ndim, dim, sl):
    out = [slice(None)] * ndim
    out[dim] = sl
    return tuple(out)


def _slice_args(args, kwargs):
    rest = list(args[1:]) + [0, None, None, 1][len(args) - 1:]
    dim = kwargs.get("dim", rest[0])
    start = kwargs.get("start", rest[1])
    end = kwargs.get("end", rest[2])
    step = kwargs.get("step", rest[3])
    return dim, slice(start, end, step)


@_rule("slice", "slice_copy")
def _slice(node, args, kwargs, spec, gm):
    x = args[0]
    dim, sl = _slice_args(args, kwargs)
    at = _slicer(x.lo.ndim, dim, sl)
    return Ival(x.lo[at], x.hi[at])


@_rule("select_scatter")
def _select_scatter(node, args, kwargs, spec, gm):
    x, src, dim, index = args[0], _iv(args[1]), args[2], args[3]
    at = _slicer(x.lo.ndim, dim, index)
    lo, hi = x.lo.copy(), x.hi.copy()
    lo[at], hi[at] = src.lo, src.hi
    return Ival(lo, hi)


@_rule("slice_scatter")
def _slice_scatter(node, args, kwargs, spec, gm):
    x, src = args[0], _iv(args[1])
    dim, sl = _slice_args([args[0]] + list(args[2:]), kwargs)
    at = _slicer(x.lo.ndim, dim, sl)
    lo, hi = x.lo.copy(), x.hi.copy()
    lo[at], hi[at] = src.lo, src.hi
    return Ival(lo, hi)


@_rule("cat", "concat", "concatenate")
def _cat(node, args, kwargs, spec, gm):
    parts = [_iv(p) for p in args[0]]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
    parts = [p for p in parts if p.lo.shape != (0,)] or parts
    return Ival(np.concatenate([p.lo for p in parts], axis=dim),
                np.concatenate([p.hi for p in parts], axis=dim))


@_rule("stack")
def _stack(node, args, kwargs, spec, gm):
    parts = [_iv(p) for p in args[0]]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
    return Ival(np.stack([p.lo for p in parts], axis=dim),
                np.stack([p.hi for p in parts], axis=dim))


@_rule("flip")
def _flip(node, args, kwargs, spec, gm):
    dims = tuple(args[1])
    return Ival(np.flip(args[0].lo, dims), np.flip(args[0].hi, dims))


def _wrap(idx: np.ndarray, n: int) -> np.ndarray:
    return np.where(idx < 0, idx + n, idx)


@_rule("index_select")
def _index_select(node, args, kwargs, spec, gm):
    x, dim, index = args[0], args[1], args[2]
    if not index.known:
        return hull_scalar(x, spec[0])
    idx = _wrap(index.lo.astype(np.int64), x.lo.shape[dim])
    if np.any((idx < 0) | (idx >= x.lo.shape[dim])):
        return hull_scalar(x, spec[0])
    return Ival(np.take(x.lo, idx, axis=dim), np.take(x.hi, idx, axis=dim))


@_rule("gather", "index", "take", "take_along_dim")
def _gather(node, args, kwargs, spec, gm):
    return hull_scalar(args[0], spec[0])


def _global_set(op: Ival, upd: Ival) -> Ival:
    u_lo = float(np.min(upd.lo)) if upd.lo.size else 0.0
    u_hi = float(np.max(upd.hi)) if upd.hi.size else 0.0
    return Ival(np.minimum(op.lo, u_lo), np.maximum(op.hi, u_hi))


@_rule("index_put")
def _index_put(node, args, kwargs, spec, gm):
    op, indices, values = args[0], list(args[1]), _iv(args[2])
    accumulate = kwargs.get("accumulate",
                            args[3] if len(args) > 3 else False)
    full = (len(indices) == op.lo.ndim
            and all(isinstance(i, Ival) and i.known for i in indices))
    if full and op.lo.ndim:
        cols = np.broadcast_arrays(*[i.lo.astype(np.int64) for i in indices])
        pts = np.stack([_wrap(c.reshape(-1), n) for c, n in
                        zip(cols, op.lo.shape)], axis=-1)
        upd = Ival(np.broadcast_to(values.lo, cols[0].shape).reshape(-1),
                   np.broadcast_to(values.hi, cols[0].shape).reshape(-1))
        out = _scatter_points(op, pts, upd, add=bool(accumulate))
        if out is not None:
            return out
    if accumulate:
        # Each element receives at most every indexed point's update.
        shapes = [i.lo.shape for i in indices if isinstance(i, Ival)]
        n = int(np.prod(np.broadcast_shapes(*shapes))) if shapes else 1
        u_lo = n * float(np.min(np.minimum(values.lo, 0.0), initial=0.0))
        u_hi = n * float(np.max(np.maximum(values.hi, 0.0), initial=0.0))
        return Ival(op.lo + u_lo, op.hi + u_hi)
    return _global_set(op, values)


@_rule("index_add")
def _index_add(node, args, kwargs, spec, gm):
    x, dim, index, src = args[0], args[1], args[2], _iv(args[3])
    src = _alpha(src, kwargs)
    dim = dim % max(x.lo.ndim, 1)
    if x.lo.ndim and index.known:
        n = x.lo.shape[dim]
        idx = _wrap(index.lo.astype(np.int64).reshape(-1), n)
        keep = (idx >= 0) & (idx < n)
        lo, hi = x.lo.copy(), x.hi.copy()
        np.add.at(np.moveaxis(lo, dim, 0), idx[keep],
                  np.moveaxis(src.lo, dim, 0)[keep])
        np.add.at(np.moveaxis(hi, dim, 0), idx[keep],
                  np.moveaxis(src.hi, dim, 0)[keep])
        return Ival(lo, hi)
    axis = dim if src.lo.ndim else None
    u_lo = np.sum(np.minimum(src.lo, 0.0), axis=axis, keepdims=True)
    u_hi = np.sum(np.maximum(src.hi, 0.0), axis=axis, keepdims=True)
    if x.lo.ndim == 0:
        u_lo, u_hi = float(np.sum(u_lo)), float(np.sum(u_hi))
    return Ival(x.lo + u_lo, x.hi + u_hi)


@_rule("index_copy", "index_fill", "scatter")
def _scatter_set(node, args, kwargs, spec, gm):
    return _global_set(args[0], _iv(args[3]))


@_rule("scatter_add")
def _scatter_add(node, args, kwargs, spec, gm):
    op, src = args[0], _iv(args[3])
    u_lo = float(np.sum(np.minimum(src.lo, 0.0)))
    u_hi = float(np.sum(np.maximum(src.hi, 0.0)))
    return Ival(op.lo + u_lo, op.hi + u_hi)


# -- reductions ----------------------------------------------------------------

def _axes(node, args, kwargs, ndim):
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    if isinstance(dim, torch.dtype):  # sum(x, dtype=...)
        dim = None
    if dim is None or (isinstance(dim, (list, tuple)) and not len(dim)):
        return tuple(range(ndim))
    if isinstance(dim, int):
        return (dim % max(ndim, 1),)
    return tuple(d % max(ndim, 1) for d in dim)


@_rule("sum", "mean", "amax", "amin", "any", "all", "max", "min")
def _reduce(node, args, kwargs, spec, gm):
    name = node.target.overloadpacket.__name__
    x = args[0]
    if name in ("max", "min") and len(args) > 1 and isinstance(args[1],
                                                                 Ival):
        return _maxmin_binary(name, x, args[1])
    if name in ("any", "all"):
        x = _truth(x)
    axes = _axes(node, args, kwargs, x.lo.ndim)
    f = {"sum": np.sum, "mean": np.mean, "amax": np.max, "amin": np.min,
         "any": np.max, "all": np.min, "max": np.max, "min": np.min}[name]
    if x.lo.size == 0:
        return None
    lo, hi = f(x.lo, axis=axes), f(x.hi, axis=axes)
    if isinstance(spec, list):  # max.dim / min.dim: (values, indices)
        n = float(np.prod([x.lo.shape[a] for a in axes]))
        vals = Ival(lo.reshape(spec[0][0]), hi.reshape(spec[0][0]))
        return [vals, Ival(np.zeros(spec[1][0]), np.full(spec[1][0], n - 1))]
    return Ival(np.reshape(lo, spec[0]), np.reshape(hi, spec[0]))


def _maxmin_binary(name, a, b):
    f = np.maximum if name == "max" else np.minimum
    return Ival(f(a.lo, b.lo), f(a.hi, b.hi))


@_rule("argmax", "argmin")
def _argmax(node, args, kwargs, spec, gm):
    x = args[0]
    dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
    n = x.lo.size if dim is None else x.lo.shape[dim]
    return Ival(np.zeros(spec[0]), np.full(spec[0], float(max(n, 1) - 1)))
