"""Analysis passes and the :class:`ProgramReport` surface (PyTorch port
of :mod:`repro.analysis.passes`).

``analyze(prog)`` extracts the event-flow graph (:mod:`.graph`) and
runs four passes over it, all static: no event ever executes.

1. **lookahead soundness**: a handler's declared ``lookahead`` is a
   promise that it never emits sooner than ``t + lookahead``; any
   provable emission bound below it (the serving-ARRIVE lookahead bug
   class) yields an ``error``.  A delay the analysis cannot bound
   yields an ``unverifiable`` verdict (warning), never a wrong bound.
2. **reachability**: a search over the emit edges from the program's
   schedule seeds (plus declared external entries); dead handlers are
   reported and the reachable type compositions (Σ* words under the
   dense codec) feed ``build(dispatch_mode="fused",
   hot_words="static")``.
3. **emit-row sanitizer**: row shape and dtype, the ``type < 0`` ν
   convention, provably negative delays, emit types past the alphabet,
   and the sharded routing key ``arg[0]``.
4. **purity/determinism**: each handler is traced a second time and
   the two aten graphs compared (their code and their constants by
   value); a difference means Python-level nondeterminism or closure
   mutation, and a tensor leaked from the first trace makes the second
   fail.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from repro_torch.analysis.absint import _attr
from repro_torch.analysis.graph import (
    HandlerNode,
    extract_graph,
    trace_handler,
)
from repro_torch.core.codec import DenseCodec, geometric_sum
from repro_torch.core.engine import _DEFAULT_HOT_W
from repro_torch.core.program import EMIT_WIDTH

_SEVERITIES = ("error", "warning", "info")

# Materialization ceiling for the reachable-word code list; the COUNT is
# always reported, the explicit enumeration only when it stays small.
_WORD_LIST_LIMIT = 100_000


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnostic."""

    severity: str      # "error" | "warning" | "info"
    pass_name: str     # "trace" | "lookahead" | "reachability" | ...
    handler: str | None
    message: str

    def __str__(self):
        where = f" [{self.handler}]" if self.handler else ""
        return f"{self.severity}: {self.pass_name}{where}: {self.message}"


@dataclasses.dataclass
class ProgramReport:
    """Everything ``analyze`` derives about one :class:`SimProgram`."""

    program: str
    names: list[str]
    nodes: dict[str, HandlerNode]
    findings: list[Finding]
    verdicts: dict[str, str]           # handler -> ok|error|unverifiable
    reachable: list[str]
    dead: list[str]
    reachable_word_count: int
    reachable_words: list[tuple] | None   # id-order, None when too many
    reachable_word_codes: list[int] | None

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def static_hot_words(self, top_w: int = _DEFAULT_HOT_W) -> list[tuple]:
        """The first ``top_w`` reachable compositions in dense-code
        order — the static counterpart of profiling a run's
        ``RunResult.word_counts`` through ``hot_words_from_counts``
        (which remains the dynamic cross-check)."""
        if self.reachable_words is not None:
            return [tuple(w) for w in self.reachable_words[:top_w]]
        ids = [self.names.index(n) for n in self.reachable]
        codec = DenseCodec(len(self.names), self._max_len)
        out = []
        for _, word in codec.words_over(ids):
            out.append(tuple(word))
            if len(out) >= top_w:
                break
        return out

    _max_len: int = 1  # set by analyze(); needed for lazy enumeration

    def to_json(self) -> str:
        def edge(e):
            return {
                "row": e.row, "dst": e.dst_name,
                "delay": [e.delay_lo, e.delay_hi],
                "arg0": [e.arg0_lo, e.arg0_hi],
                "conditional": e.conditional,
            }

        def clean(x):
            if isinstance(x, float):
                if math.isinf(x):
                    return "inf" if x > 0 else "-inf"
                if math.isnan(x):
                    return "nan"
            if isinstance(x, dict):
                return {k: clean(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [clean(v) for v in x]
            return x

        return json.dumps(clean({
            "program": self.program,
            "handlers": {
                name: {
                    "type_id": n.type_id,
                    "lookahead": n.lookahead,
                    "emits": n.emits,
                    "entity": n.entity,
                    "verdict": self.verdicts.get(name, "ok"),
                    "min_delay_lo": n.min_delay_lo,
                    "fan_out": len(n.edges),
                    "arg_used": n.arg_used,
                    "may_emit_any": n.may_emit_any,
                    "nu_rows": list(n.nu_rows),
                    "edges": [edge(e) for e in n.edges],
                    "trace_error": n.trace_error,
                }
                for name, n in self.nodes.items()
            },
            "reachable": self.reachable,
            "dead": self.dead,
            "reachable_word_count": self.reachable_word_count,
            "reachable_word_codes": self.reachable_word_codes,
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }), indent=2)

    def to_text(self) -> str:
        def fmt(x):
            if math.isinf(x):
                return "inf" if x > 0 else "-inf"
            return f"{x:g}"

        lines = [f"program {self.program!r}: "
                 f"{len(self.nodes)} handler(s), "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        for name, n in self.nodes.items():
            kind = ("entity" if n.entity
                    else "emits" if n.emits else "leaf")
            verdict = self.verdicts.get(name, "ok")
            lines.append(
                f"  {name} (#{n.type_id}, {kind}, "
                f"lookahead={fmt(n.lookahead)}): {verdict}"
            )
            for e in n.edges:
                cond = " (conditional)" if e.conditional else ""
                lines.append(
                    f"    -> {e.dst_name} delay [{fmt(e.delay_lo)}, "
                    f"{fmt(e.delay_hi)}] arg0 [{fmt(e.arg0_lo)}, "
                    f"{fmt(e.arg0_hi)}]{cond}"
                )
            if n.nu_rows:
                lines.append(f"    nu rows: {list(n.nu_rows)}")
            if n.trace_error:
                lines.append(f"    trace error: {n.trace_error}")
        lines.append(
            f"  reachable: {self.reachable or '(none derivable)'}"
        )
        if self.dead:
            lines.append(f"  dead: {self.dead}")
        lines.append(
            f"  reachable compositions: {self.reachable_word_count}"
        )
        for f in self.findings:
            lines.append(f"  {f}")
        return "\n".join(lines)


def _lookahead_pass(nodes, findings, verdicts):
    tol = 1e-9
    for name, n in nodes.items():
        if not n.emits or n.entity:
            verdicts[name] = "ok"
            continue
        if n.trace_error is not None:
            verdicts[name] = "unverifiable"
            continue
        if not n.edges:
            verdicts[name] = "ok"
            findings.append(Finding(
                "info", "lookahead", name,
                "declared emits=True but no emitting row is derivable "
                "(every row is provably a ν row)",
            ))
            continue
        finite = [e.delay_lo for e in n.edges
                  if not math.isinf(e.delay_lo)]
        unbounded = [e for e in n.edges if e.delay_lo == -math.inf]
        # Timestamps (and every handler constant) live on the f32 grid,
        # so the bound the window rule actually trusts is the f32
        # rounding of the declared lookahead — comparing against the
        # f64 literal would flag e.g. lookahead=0.4 against a handler
        # whose min delay is exactly f32(0.4).
        la = (float(np.float32(n.lookahead))
              if math.isfinite(n.lookahead) else n.lookahead)
        if finite and min(finite) < la - tol:
            worst = min(finite)
            verdicts[name] = "error"
            findings.append(Finding(
                "error", "lookahead", name,
                f"declared lookahead {n.lookahead:g} exceeds the "
                f"provable min emission delay {worst:g}: the "
                "conservative window may execute an event this handler "
                "preempts (the serving-ARRIVE bug class) — lower "
                f"the lookahead to <= {worst:g} or raise the emission "
                "delay",
            ))
        elif unbounded:
            verdicts[name] = "unverifiable"
            rows = sorted({e.row for e in unbounded})
            findings.append(Finding(
                "warning", "lookahead", name,
                f"emission delay on row(s) {rows} is data-dependent; "
                f"cannot verify the declared lookahead "
                f"{n.lookahead:g} statically",
            ))
        else:
            verdicts[name] = "ok"
    return verdicts


def _sanitize_pass(prog, nodes, findings):
    max_emit = prog.config.max_emit
    T = len(prog)
    for name, n in nodes.items():
        if n.trace_error is not None:
            findings.append(Finding(
                "error", "trace", name,
                f"handler could not be traced/analyzed on the portable "
                f"layout: {n.trace_error}",
            ))
            continue
        if not n.emits:
            continue
        if n.emits_shape is not None and n.emits_shape != (
                max_emit, EMIT_WIDTH):
            findings.append(Finding(
                "error", "sanitize", name,
                f"emits shape {n.emits_shape} != "
                f"({max_emit}, {EMIT_WIDTH}) = (config.max_emit, "
                "2+ARG_WIDTH); build() would reject this at the first "
                "batch",
            ))
        if n.emits_dtype is not None and n.emits_dtype != "float32":
            findings.append(Finding(
                "warning", "sanitize", name,
                f"emits dtype {n.emits_dtype} (the adapter coerces to "
                "float32; emit values must survive that cast)",
            ))
        for r, (d_lo, d_hi, t_lo, t_hi, _, _) in enumerate(n.row_bounds):
            if t_hi < 0:
                continue  # pure ν row
            if t_lo == t_hi and math.isfinite(t_lo) \
                    and t_lo != int(t_lo):
                findings.append(Finding(
                    "error", "sanitize", name,
                    f"row {r} emits the constant non-integer type "
                    f"{t_lo:g}; types are integral ids "
                    f"(ν rows use type < 0)",
                ))
            if math.isfinite(t_hi) and t_hi > T - 1:
                findings.append(Finding(
                    "error", "sanitize", name,
                    f"row {r} can emit type up to {t_hi:g} but only "
                    f"{T} type(s) are registered",
                ))
            if math.isinf(t_hi):
                findings.append(Finding(
                    "warning", "sanitize", name,
                    f"row {r} emit type is data-dependent; treating it "
                    "as 'may emit any type' for reachability",
                ))
            if d_hi < 0:
                findings.append(Finding(
                    "error", "sanitize", name,
                    f"row {r} delay is provably negative "
                    f"([{d_lo:g}, {d_hi:g}]): events cannot be "
                    "scheduled into the past",
                ))
        # Sharded builds route by arg[0]; a routing key that is
        # provably negative on an emitting row is a blank template
        # (e.g. torch.full(..., -1.0)) left unset.
        bad_rows = sorted({e.row for e in n.edges if e.arg0_hi < 0})
        if bad_rows:
            findings.append(Finding(
                "warning", "sanitize", name,
                f"routing key arg[0] is provably negative on emitting "
                f"row(s) {bad_rows}; sharded builds "
                "(build(shards=N)) route every event by arg[0] — set "
                "it explicitly on each emitting row",
            ))


def _graph_repr(gm) -> str:
    """A trace's code plus its constants, every value of each (a
    mutated closure tensor is a ``get_attr`` whose name does not
    change)."""
    consts = []
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            value = _attr(gm, node.target)
            try:
                consts.append(repr((str(value.dtype), tuple(value.shape),
                                    value.detach().cpu().reshape(-1)
                                    .tolist())))
            except Exception:  # no data (the meta device), or no tensor
                consts.append(repr(value))
    return gm.code + "\n#consts: " + "|".join(consts)


def _purity_pass(prog, state, nodes, findings, traces):
    for spec in prog._specs:
        node = nodes[spec.name]
        if node.trace_error is not None:
            continue  # trace pass already reported
        first, _ = traces[spec.name]
        # torch has no jax.checking_leaks: a tensor the first trace
        # leaked (kept in a closure) makes this one fail instead.
        traced, err = trace_handler(spec, state, prog.config.max_emit)
        if traced is None:
            findings.append(Finding(
                "error", "purity", spec.name,
                f"handler failed to re-trace: {err}",
            ))
            continue
        if _graph_repr(first.gm) != _graph_repr(traced.gm):
            findings.append(Finding(
                "error", "purity", spec.name,
                "tracing the handler twice produced different graphs: "
                "the handler is not a pure function of (state, t, arg) "
                "(Python-level randomness, closure mutation, or "
                "iteration over an unordered container)",
            ))


def _reachability_pass(prog, nodes, roots, findings):
    names = list(prog.names)
    root_ids = set()
    for (_, type_id, _) in prog._schedule:
        root_ids.add(int(type_id))
    for name in getattr(prog, "_entries", ()):
        root_ids.add(prog.type_id(name))
    for r in roots:
        root_ids.add(prog.type_id(r) if isinstance(r, str) else int(r))

    if not root_ids:
        findings.append(Finding(
            "warning", "reachability", None,
            "no schedule seeds, external entries, or roots= given; "
            "treating every handler as reachable (declare entry points "
            "with prog.external_entry(...) for a real reachability "
            "check)",
        ))
        reachable = set(range(len(names)))
    else:
        reachable = set()
        frontier = sorted(root_ids)
        while frontier:
            tid = frontier.pop()
            if tid in reachable:
                continue
            reachable.add(tid)
            node = nodes[names[tid]]
            if node.emits and node.trace_error is not None:
                # Cannot see its edges: soundly assume it reaches all.
                frontier.extend(t for t in range(len(names))
                                if t not in reachable)
                continue
            frontier.extend(e.dst for e in node.edges
                            if e.dst not in reachable)

    dead = [names[t] for t in range(len(names)) if t not in reachable]
    for name in dead:
        findings.append(Finding(
            "warning", "reachability", name,
            "handler is unreachable from the schedule seeds and "
            "declared external entries (dead event type); remove it or "
            "declare prog.external_entry(...)",
        ))
    return sorted(reachable), dead


def analyze(prog, state=None, roots=()) -> ProgramReport:
    """Statically analyze a :class:`SimProgram`.

    ``state`` supplies the shape/dtype template the handlers are traced
    with (values are never read, and a template on the card gives the
    report one on the CPU gives); defaults to the program's declared
    ``example_state``.  ``roots`` adds extra reachability seeds (type
    names or ids) beyond the schedule and ``external_entry``
    declarations.
    """
    if state is None:
        state = getattr(prog, "_example_state", None)
    if state is None:
        raise ValueError(
            "analyze() needs a state template to trace handlers "
            "against: pass state= (or declare it once with "
            "prog.example_state(state))"
        )
    prog.freeze()
    names = list(prog.names)
    traces: dict = {}
    nodes = extract_graph(prog, state, traces)
    findings: list[Finding] = []
    verdicts: dict[str, str] = {}

    _sanitize_pass(prog, nodes, findings)
    _lookahead_pass(nodes, findings, verdicts)
    _purity_pass(prog, state, nodes, findings, traces)
    reachable_ids, dead = _reachability_pass(prog, nodes, roots, findings)

    max_len = prog.config.max_batch_len
    n_reach = len(reachable_ids)
    word_count = geometric_sum(n_reach, max_len) if n_reach else 0
    words = codes = None
    if 0 < word_count <= _WORD_LIST_LIMIT:
        # Codes are DENSE codes: the device engine always uses the
        # dense codec, so these index RunResult.word_counts directly.
        dense = DenseCodec(len(names), max_len)
        words, codes = [], []
        for code, word in dense.words_over(reachable_ids):
            words.append(tuple(word))
            codes.append(code)

    report = ProgramReport(
        program=prog.name,
        names=names,
        nodes=nodes,
        findings=sorted(
            findings, key=lambda f: _SEVERITIES.index(f.severity)),
        verdicts=verdicts,
        reachable=[names[t] for t in reachable_ids],
        dead=dead,
        reachable_word_count=word_count,
        reachable_words=words,
        reachable_word_codes=codes,
    )
    report._max_len = max_len
    return report
