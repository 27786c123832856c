"""The port's static analyzer (``repro_torch.analysis``) against JAX's.

The regression corpus of intentionally broken programs
(``tests/test_analysis.py``) restated in torch, each case held to the
finding JAX's analyzer gives the same program (severity, pass and
handler); the exact bounds of PHOLD and the serving ARRIVE as literals;
the int64 mask rules the port's u32 hashes need; the property test; the
clean bill of the six analyzer targets and the CLI; static against
profiled hot words; ``build(check=)`` and ``hot_words="static"``; a
parity test of each target's whole report against JAX's; and a
soundness-by-execution test: every row the targets' handlers emit on
seeded random inputs lies inside the port's bounds.

JAX's side runs with ``"jit"`` added to ``absint._SUBJAXPR_PRIMS`` in
the test process only (the nested-jaxpr primitive's name in jax 0.9;
without it JAX's ``%`` rule never fires, ROADMAP C).  Tolerance: exact.
"""

import json
import sys
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

import jax.numpy as jnp

import repro.analysis.absint as jabsint
from _hypothesis_compat import given, settings, st
from repro import poc as jpoc
from repro.analysis import analyze as janalyze
from repro.core.program import Config as JConfig
from repro.core.program import SimProgram as JProgram
from repro.serving import scenarios as jsc
from repro_torch.analysis import analyze
from repro_torch.analysis.absint import Ival, eval_graph_ivals, unknown_ival
from repro_torch.analysis.graph import trace_handler
from repro_torch.api import AnalysisError, Config, PoissonSource, SimProgram
from repro_torch.core import queue as tq
from repro_torch.core.codec import DenseCodec
from repro_torch.core.tree import tree_map
from repro_torch.examples import mmc_network as tmmc
from repro_torch.examples import phold as tphold
from repro_torch.examples import wireless_des as twireless
from repro_torch.serving import scenarios as tsc
import repro_torch.poc as tpoc

from test_torch_engine import ROOT

sys.path.insert(0, str(ROOT / "examples"))
import mmc_network as jmmc  # noqa: E402  (examples/ is not a package)
import phold as jphold  # noqa: E402
import wireless_des as jwireless  # noqa: E402

# (port target, JAX target) of every in-repo analyzer target.
TARGETS = {
    "phold": (tphold.make_program, jphold.make_program),
    "mmc": (tmmc.make_program, jmmc.make_program),
    "admission": (tsc.make_program, jsc.make_program),
    "open_admission": (tsc.make_open_program, jsc.make_open_program),
    "poc": (tpoc.make_program, jpoc.make_program),
    "wireless": (twireless.make_program, jwireless.make_program),
}


@pytest.fixture
def jax_jit_rule(monkeypatch):
    monkeypatch.setattr(jabsint, "_SUBJAXPR_PRIMS",
                        jabsint._SUBJAXPR_PRIMS | {"jit"})


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _tprog(max_emit=1, max_batch_len=4, name="corpus"):
    return SimProgram(name, config=Config(
        max_batch_len=max_batch_len, capacity=64, max_emit=max_emit))


def _jprog(max_emit=1, max_batch_len=4, name="corpus"):
    return JProgram(name, config=JConfig(
        max_batch_len=max_batch_len, capacity=64, max_emit=max_emit))


def _trow(e, r, delay, type_, arg0=0.0):
    e[r, 0] = delay
    e[r, 1] = type_
    e[r, 2] = arg0
    return e


def _jrow(e, r, delay, type_, arg0=0.0):
    return e.at[r, 0].set(delay).at[r, 1].set(type_).at[r, 2].set(arg0)


def _tblank(max_emit=1):
    return torch.full((max_emit, 6), -1.0)


def _jblank(max_emit=1):
    return jnp.full((max_emit, 6), -1.0, jnp.float32)


def _find(report, pass_name, severity=None):
    return [f for f in report.findings
            if f.pass_name == pass_name
            and (severity is None or f.severity == severity)]


def _keys(report):
    return sorted((f.severity, f.pass_name, f.handler)
                  for f in report.findings)


# ---------------------------------------------------------------------------
# the regression corpus, each case in both packages
# ---------------------------------------------------------------------------

def _case_bad_lookahead(pkg):
    if pkg == "torch":
        prog = _tprog()
        prog.register("A", lambda s, t, a: (s + 1, _trow(
            _tblank(), 0, 1.0, 0.0)), lookahead=5.0, emits=True)
        state = torch.tensor(0, dtype=torch.int32)
    else:
        prog = _jprog()
        prog.register("A", lambda s, t, a: (s + 1, _jrow(
            _jblank(), 0, 1.0, 0.0)), lookahead=5.0, emits=True)
        state = jnp.int32(0)
    prog.schedule(0.0, "A")
    return prog, state


def _case_wrong_row_width(pkg):
    if pkg == "torch":
        prog = _tprog()
        prog.register("A", lambda s, t, a: (s, torch.zeros((1, 4))),
                      lookahead=1.0, emits=True)
        state = torch.tensor(0, dtype=torch.int32)
    else:
        prog = _jprog()
        prog.register("A", lambda s, t, a: (s, jnp.zeros((1, 4))),
                      lookahead=1.0, emits=True)
        state = jnp.int32(0)
    prog.schedule(0.0, "A")
    return prog, state


def _case_wrong_row_count(pkg):
    if pkg == "torch":
        prog = _tprog(max_emit=2)
        prog.register("A", lambda s, t, a: (s, _trow(
            _tblank(1), 0, 1.0, 0.0)), lookahead=1.0, emits=True)
        state = torch.tensor(0, dtype=torch.int32)
    else:
        prog = _jprog(max_emit=2)
        prog.register("A", lambda s, t, a: (s, _jrow(
            _jblank(1), 0, 1.0, 0.0)), lookahead=1.0, emits=True)
        state = jnp.int32(0)
    prog.schedule(0.0, "A")
    return prog, state


def _case_dead_handler(pkg, entry=False):
    if pkg == "torch":
        prog = _tprog()
        prog.register("LIVE", lambda s, t, a: (s, _trow(
            _tblank(), 0, 1.0, 0.0)), lookahead=1.0, emits=True)
        state = torch.tensor(0, dtype=torch.int32)
    else:
        prog = _jprog()
        prog.register("LIVE", lambda s, t, a: (s, _jrow(
            _jblank(), 0, 1.0, 0.0)), lookahead=1.0, emits=True)
        state = jnp.int32(0)
    prog.register("DEAD", lambda s, t, a: s)
    prog.schedule(0.0, "LIVE")
    if entry:
        prog.external_entry("DEAD")
    return prog, state


def _case_missing_routing_key(pkg):
    if pkg == "torch":
        def a(s, t, arg):
            e = _tblank()  # arg columns stay -1.0
            e[0, 0] = 1.0
            e[0, 1] = 0.0
            return s, e
        prog = _tprog()
        state = torch.tensor(0, dtype=torch.int32)
    else:
        def a(s, t, arg):
            return s, _jblank().at[0, 0].set(1.0).at[0, 1].set(0.0)
        prog = _jprog()
        state = jnp.int32(0)
    prog.register("A", a, lookahead=1.0, emits=True)
    prog.schedule(0.0, "A")
    return prog, state


def _case_impure(pkg):
    box = [0]
    if pkg == "torch":
        def a(s, t, arg):
            box[0] += 1  # closure mutation changes the traced constant
            return s, _trow(_tblank(), 0, 1.0 + box[0], 0.0)
        prog = _tprog()
        state = torch.tensor(0, dtype=torch.int32)
    else:
        def a(s, t, arg):
            box[0] += 1
            return s, _jrow(_jblank(), 0, 1.0 + box[0], 0.0)
        prog = _jprog()
        state = jnp.int32(0)
    prog.register("A", a, lookahead=1.0, emits=True)
    prog.schedule(0.0, "A")
    return prog, state


def _const_row_case(delay, type_, lookahead):
    def build(pkg):
        if pkg == "torch":
            prog = _tprog()
            prog.register("A", lambda s, t, a: (s, _trow(
                _tblank(), 0, delay, type_)), lookahead=lookahead,
                emits=True)
            state = torch.tensor(0, dtype=torch.int32)
        else:
            prog = _jprog()
            prog.register("A", lambda s, t, a: (s, _jrow(
                _jblank(), 0, delay, type_)), lookahead=lookahead,
                emits=True)
            state = jnp.int32(0)
        prog.schedule(0.0, "A")
        return prog, state
    return build


def _case_hash_mod(pkg):
    if pkg == "torch":
        def a(s, t, arg):
            h = torch.abs((s + 7) * 1103515245)
            d = 0.5 + (h % 8).to(torch.float32) * 0.25
            return s + 1, _trow(_tblank(), 0, d, 0.0)
        prog = _tprog()
        state = torch.tensor(0, dtype=torch.int32)
    else:
        def a(s, t, arg):
            h = jnp.abs((s + jnp.int32(7)) * jnp.int32(1103515245))
            d = 0.5 + (h % jnp.int32(8)).astype(jnp.float32) * 0.25
            return s + 1, _jrow(_jblank(), 0, d, 0.0)
        prog = _jprog()
        state = jnp.int32(0)
    prog.register("A", a, lookahead=0.5, emits=True)
    prog.schedule(0.0, "A")
    return prog, state


def _case_data_dependent(pkg, nonneg=False):
    if pkg == "torch":
        def a(s, t, arg):
            return s, _trow(_tblank(), 0, torch.abs(s) if nonneg else s, 0.0)
        prog = _tprog()
        state = torch.tensor(0.0)
    else:
        def a(s, t, arg):
            return s, _jrow(_jblank(), 0, jnp.abs(s) if nonneg else s, 0.0)
        prog = _jprog()
        state = jnp.float32(0.0)
    prog.register("A", a, lookahead=1.0, emits=True)
    prog.schedule(0.0, "A")
    return prog, state


def _case_nu_rows(pkg):
    if pkg == "torch":
        def a(s, t, arg):
            e = _tblank(3)
            _trow(e, 0, 1.5, 0.0)          # real emission
            _trow(e, 1, 0.0, -1.0)         # ν: delay 0 must NOT count
            e[2, 0] = -5.0                 # ν with negative delay: fine
            return s, e
        prog = _tprog(max_emit=3)
        state = torch.tensor(0, dtype=torch.int32)
    else:
        def a(s, t, arg):
            e = _jrow(_jrow(_jblank(3), 0, 1.5, 0.0), 1, 0.0, -1.0)
            return s, e.at[2, 0].set(-5.0)
        prog = _jprog(max_emit=3)
        state = jnp.int32(0)
    prog.register("A", a, lookahead=1.0, emits=True)
    prog.schedule(0.0, "A")
    return prog, state


def _case_entity(pkg):
    prog = _tprog() if pkg == "torch" else _jprog()
    prog.entity_handler("TALLY")(lambda es, t, a: es + 1)
    prog.handler("LEAF", lookahead=2.0)(lambda s, t, a: s)
    prog.schedule(0.0, "TALLY", arg=[0.0])
    prog.schedule(0.0, "LEAF")
    state = (torch.zeros(4, dtype=torch.int32) if pkg == "torch"
             else jnp.zeros((4,), jnp.int32))
    return prog, state


# name -> (the case's program factory, the finding the torch report must
# carry or None)
CORPUS = {
    "bad_lookahead": (_case_bad_lookahead, ("error", "lookahead", "lookahead")),
    "wrong_row_width": (_case_wrong_row_width, ("error", "sanitize", "shape")),
    "wrong_row_count": (_case_wrong_row_count, ("error", "sanitize", "shape")),
    "dead_handler": (_case_dead_handler, ("warning", "reachability", "dead")),
    "dead_handler_entry": (lambda pkg: _case_dead_handler(pkg, True), None),
    "missing_routing_key": (_case_missing_routing_key,
                            ("warning", "sanitize", "routing key")),
    "impure": (_case_impure, ("error", "purity", "pure")),
    "negative_delay": (_const_row_case(-1.0, 0.0, 0.1),
                       ("error", "sanitize", "negative")),
    "out_of_range_type": (_const_row_case(1.0, 7.0, 1.0),
                          ("error", "sanitize", "registered")),
    "non_integer_type": (_const_row_case(1.0, 0.5, 1.0),
                         ("error", "sanitize", "non-integer")),
    "hash_mod": (_case_hash_mod, None),
    "data_dependent_delay": (_case_data_dependent,
                             ("warning", "lookahead", "data-dependent")),
    "data_dependent_nonneg": (lambda pkg: _case_data_dependent(pkg, True),
                              ("error", "lookahead", "lookahead")),
    "nu_rows": (_case_nu_rows, None),
    "entity_and_leaf": (_case_entity, None),
}


def _edge_rows(report):
    return {name: [(e.row, e.dst, e.delay_lo, e.delay_hi, e.arg0_lo,
                    e.arg0_hi, e.conditional) for e in n.edges]
            for name, n in report.nodes.items()}


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_corpus_matches_jax(case, jax_jit_rule):
    """Each bug class caught statically, with JAX's finding: the same
    (severity, pass, handler) keys, verdicts, ν rows and edge bounds."""
    build, want = CORPUS[case]
    tprog, tstate = build("torch")
    jprog, jstate = build("jax")
    trep = analyze(tprog, state=tstate)
    jrep = janalyze(jprog, state=jstate)
    assert _keys(trep) == _keys(jrep), (trep.to_text(), jrep.to_text())
    assert trep.verdicts == jrep.verdicts
    assert trep.dead == jrep.dead and trep.reachable == jrep.reachable
    assert _edge_rows(trep) == _edge_rows(jrep)
    assert {k: n.nu_rows for k, n in trep.nodes.items()} == \
        {k: n.nu_rows for k, n in jrep.nodes.items()}
    if want is not None:
        severity, pass_name, word = want
        msgs = [f.message for f in _find(trep, pass_name, severity)]
        assert any(word in m for m in msgs), msgs


def test_corpus_bounds_as_literals():
    """The edge cases' bounds, from the port alone."""
    rep = analyze(*_case_hash_mod("torch"))
    [edge] = rep.nodes["A"].edges
    assert (edge.delay_lo, edge.delay_hi) == (0.5, 0.5 + 7 * 0.25)
    assert rep.verdicts["A"] == "ok"
    rep = analyze(*_case_nu_rows("torch"))
    assert rep.nodes["A"].nu_rows == (1, 2)
    assert rep.nodes["A"].min_delay_lo == 1.5 and not rep.errors
    rep = analyze(*_case_data_dependent("torch"))
    [edge] = rep.nodes["A"].edges
    assert edge.delay_lo == -np.inf and rep.verdicts["A"] == "unverifiable"
    rep = analyze(*_case_data_dependent("torch", nonneg=True))
    [edge] = rep.nodes["A"].edges
    assert (edge.delay_lo, edge.delay_hi) == (0.0, np.inf)
    assert rep.verdicts["A"] == "error"
    rep = analyze(*_case_entity("torch"))
    assert rep.verdicts == {"TALLY": "ok", "LEAF": "ok"}
    assert rep.nodes["TALLY"].edges == [] and not rep.errors
    rep = analyze(*_case_dead_handler("torch"))
    assert rep.dead == ["DEAD"]
    assert analyze(*_case_dead_handler("torch", True)).dead == []


def test_corpus_runs_no_handler():
    """The analysis traces with fake tensors: the handler's body runs
    (that is tracing), but never on a real tensor, and no event runs.
    A build with ``check="error"`` raises before the engine exists."""
    seen = []
    prog = _tprog()

    @prog.handler("A", lookahead=5.0, emits=True)
    def a(state, t, arg):
        seen.append(is_fake(t))
        return state + 1, _trow(_tblank(), 0, 1.0, 0.0)

    prog.schedule(0.0, "A")
    prog.example_state(torch.tensor(0, dtype=torch.int32))
    tq.COUNTS.clear()
    report = analyze(prog)
    assert report.verdicts["A"] == "error"
    assert seen and all(seen), seen
    with pytest.raises(AnalysisError, match="lookahead"):
        prog.build(device="cpu", check="error")
    assert all(seen), seen
    assert not any(tq.COUNTS.values())


@pytest.mark.parametrize("backend", [
    dict(backend="device"),
    dict(backend="host", scheduler="unbatched", jit_handlers=False),
])
def test_deferred_check_fires_before_any_event(backend):
    seen = []
    prog = _tprog()

    @prog.handler("A", lookahead=5.0, emits=True)
    def a(state, t, arg):
        seen.append(is_fake(t))
        return state + 1, _trow(_tblank(), 0, 1.0, 0.0)

    prog.schedule(0.0, "A")
    # No example state: the check defers to the first run(), which must
    # still raise before dispatching anything.
    sim = prog.build(device="cpu", check="error", **backend)
    assert not seen
    with pytest.raises(AnalysisError, match="lookahead"):
        sim.run(torch.tensor(0, dtype=torch.int32))
    assert all(seen), seen


def test_check_modes():
    prog = tphold.make_program()
    with pytest.raises(ValueError, match="check mode"):
        prog.build(device="cpu", check="strict")
    prog.build(device="cpu", check="error")  # clean: builds
    bad, state = _case_bad_lookahead("torch")
    bad.example_state(state)
    with pytest.warns(UserWarning, match="lookahead"):
        sim = bad.build(device="cpu", check="warn")
    res = sim.run(state, max_batches=3)
    assert res.events == 3
    # A deferred check runs once: the second run does not analyze again.
    bad2, state = _case_bad_lookahead("torch")
    sim = bad2.build(device="cpu", check="warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim.run(state, max_batches=1)
        sim.run(state, max_batches=1)
    assert sum("lookahead" in str(w.message) for w in caught) == 1


# ---------------------------------------------------------------------------
# the int64 hash rules and the domain's edges
# ---------------------------------------------------------------------------

def _bounds_of(fn, *inputs):
    """The output interval of ``fn`` traced over unknown ``inputs``."""
    spec = type("S", (), dict(entity=False, fn=staticmethod(
        lambda s, t, a: fn(*s))))
    traced, err = trace_handler(spec, list(inputs), 1)
    assert err is None, err
    ivs = [unknown_ival(tuple(n.meta["val"].shape), n.meta["val"].dtype)
           for n in traced.gm.graph.nodes if n.op == "placeholder"]
    [out] = eval_graph_ivals(traced.gm, ivs)
    return float(out.lo.min()), float(out.hi.max())


def test_int64_mask_rules():
    """The port's u32 hashes live in int64: ``x & c`` with a known
    ``c >= 0`` is ``[0, c]`` whatever x is (JAX's rule gives up when
    x may be negative), ``>>`` of ``[0, 2^k)`` stays there, ``^`` of two
    values in ``[0, 2^k)`` too; products past int64 widen."""
    x = torch.zeros((), dtype=torch.int64)
    m32 = 0xFFFFFFFF
    assert _bounds_of(lambda v: v & m32, x) == (0.0, float(m32))
    assert _bounds_of(lambda v: (v * 2654435761) & m32, x) == (0.0, m32)
    assert _bounds_of(lambda v: (v & m32) >> 13, x) == (0.0, 2.0**19 - 1)
    assert _bounds_of(lambda v: (v & m32) ^ ((v & m32) >> 15), x) == (
        0.0, float(m32))
    assert _bounds_of(lambda v: (v & 0xFF) | 0x100, x) == (256.0, 511.0)
    assert _bounds_of(lambda v: v & -8, x) == (-2.0**63, 2.0**63)
    assert _bounds_of(lambda v: (v & m32) * 0x5BD1E995, x) == (
        0.0, float(m32) * 0x5BD1E995)
    # abs(-2**31) stays -2**31 in int32: the bound must widen, not clip.
    i32 = torch.zeros((), dtype=torch.int32)
    assert _bounds_of(lambda v: torch.abs(v), i32) == (-2.0**31, 2.0**31 - 1)
    assert _bounds_of(lambda v: torch.abs(v) % 8, i32) == (0.0, 7.0)
    assert _bounds_of(lambda v: (v & 7) // 2, i32) == (0.0, 3.0)
    # An op without a rule is unknown, never invented.
    f = torch.zeros((), dtype=torch.float32)
    assert _bounds_of(lambda v: torch.atan(v), f) == (-np.inf, np.inf)


def test_folding_runs_known_ops_only():
    """Known inputs are executed exactly; random and uninitialized
    creations are never folded."""
    f = torch.zeros((), dtype=torch.float32)
    assert _bounds_of(lambda v: torch.full((3,), 2.0).sum() + 0 * v,
                      f) == (-np.inf, np.inf)  # 0 * unknown is unknown
    assert _bounds_of(lambda v: torch.full((3,), 2.0).sum().expand(2),
                      f) == (6.0, 6.0)
    assert _bounds_of(lambda v: torch.rand(()), f) == (-np.inf, np.inf)
    assert _bounds_of(lambda v: torch.empty((2,), dtype=torch.int32),
                      f) == (-2.0**31, 2.0**31 - 1)


def test_template_device_and_closure_faults():
    """Values and devices of the template are never read: a template
    of other values (or on another device) gives the same report, and a
    handler that closes over a tensor of another device is a trace
    finding, not a crash."""
    prog = tphold.make_program()
    base = analyze(prog).to_json()
    other = {"counts": torch.full((8,), 5, dtype=torch.int32),
             "checksum": torch.tensor(99, dtype=torch.int64)}
    assert analyze(prog, state=other).to_json() == base
    on_meta = tree_map(lambda x: x.to("meta"), other)
    assert analyze(prog, state=on_meta).to_json() == base

    far = torch.ones((4,), device="meta")
    prog = _tprog()
    prog.register("A", lambda s, t, a: (s, _trow(
        _tblank(), 0, (far + a)[0], 0.0)), lookahead=1.0, emits=True)
    prog.schedule(0.0, "A")
    rep = analyze(prog, state=torch.tensor(0))
    [f] = _find(rep, "trace", "error")
    assert f.handler == "A" and rep.verdicts["A"] == "unverifiable"
    # A closed-over CPU table is a constant, read by value.
    table = torch.tensor([[0.5], [1.5], [2.5]])
    prog = _tprog()
    prog.register("A", lambda s, t, a: (s, _trow(
        _tblank(), 0, table.index_select(0, (s % 3).reshape(1))[0, 0],
        0.0)), lookahead=0.5, emits=True)
    prog.schedule(0.0, "A")
    rep = analyze(prog, state=torch.tensor(0))
    [edge] = rep.nodes["A"].edges
    assert (edge.delay_lo, edge.delay_hi) == (0.5, 2.5) and rep.ok


def test_leaked_tracer_is_a_purity_error():
    box = []
    prog = _tprog()

    @prog.handler("A", lookahead=1.0, emits=True)
    def a(state, t, arg):
        if not box:
            box.append(t)  # leaks the first trace's tensor
        return state, _trow(_tblank(), 0, 1.0 + 0.0 * box[0], 0.0)

    prog.schedule(0.0, "A")
    rep = analyze(prog, state=torch.tensor(0))
    [f] = _find(rep, "purity", "error")
    assert f.handler == "A"


@settings(max_examples=25, deadline=None)
@given(
    delay=st.floats(min_value=0.25, max_value=8.0, width=32,
                    allow_nan=False),
    lookahead=st.floats(min_value=0.25, max_value=8.0, width=32,
                        allow_nan=False),
    data_dep=st.booleans(),
)
def test_property_verdict_matches_ground_truth(delay, lookahead, data_dep):
    """For constant delays the verdict equals the ground-truth
    comparison on the f32 grid; for state-dependent delays the bound is
    unknown (never a wrong finite bound)."""
    prog = SimProgram("prop", config=Config(max_batch_len=2, max_emit=1))

    @prog.handler("A", lookahead=lookahead, emits=True)
    def a(state, t, arg):
        d = state if data_dep else torch.tensor(delay, dtype=torch.float32)
        return state, _trow(_tblank(), 0, d, 0.0)

    prog.schedule(0.0, "A")
    report = analyze(prog, state=torch.tensor(1.0))
    [edge] = report.nodes["A"].edges
    if data_dep:
        assert edge.delay_lo == -np.inf
        assert report.verdicts["A"] == "unverifiable"
    else:
        lo = float(np.float32(delay))
        assert edge.delay_lo == lo
        unsound = lo < float(np.float32(lookahead)) - 1e-9
        assert report.verdicts["A"] == ("error" if unsound else "ok")


# ---------------------------------------------------------------------------
# the analyzer targets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [
    "repro_torch.examples.phold:make_program",
    "repro_torch.examples.mmc_network:make_program",
    "repro_torch.serving.scenarios:make_program",
    "repro_torch.serving.scenarios:make_open_program",
    "repro_torch.poc:make_program",
    "repro_torch.examples.wireless_des:make_program",
])
def test_all_scenarios_are_clean(target):
    from repro_torch.analysis.__main__ import _resolve

    report = analyze(_resolve(target))
    assert report.ok, [str(f) for f in report.errors]
    assert not report.dead, report.dead
    assert all(v in ("ok", "unverifiable")
               for v in report.verdicts.values())


def test_phold_bounds_are_exact():
    report = analyze(tphold.make_program())
    [node] = report.nodes.values()
    assert node.min_delay_lo == 1.0  # == lookahead
    assert [(e.delay_lo, e.delay_hi, e.arg0_lo, e.arg0_hi)
            for e in node.edges] == [(1.0, 4.5, 0.0, 7.0)]
    assert report.verdicts["HOP"] == "ok"
    assert not report.findings


def test_serving_arrive_lookahead_verifies_exactly():
    """ARRIVE's 0.25 lookahead is exactly its provable min emission
    delay (JAX's analyzer reports a false error here unless its ``%``
    rule fires)."""
    report = analyze(tsc.make_program())
    arrive = report.nodes["ARRIVE"]
    assert arrive.min_delay_lo == 0.25
    assert [(e.dst_name, e.delay_lo, e.delay_hi) for e in arrive.edges] == [
        ("ARRIVE", 0.25, 2.0), ("ADMIT", 0.25, 0.25)]
    assert report.verdicts["ARRIVE"] == "ok"
    assert not report.errors and not report.warnings


def test_cli_text_json_and_strict(capsys, tmp_path, monkeypatch):
    from repro_torch.analysis.__main__ import main

    target = "repro_torch.examples.phold:make_program"
    assert main([target, "--strict", "--hot-words", "2"]) == 0
    out = capsys.readouterr().out
    assert "HOP" in out and "ok" in out and "[(0,), (0, 0)]" in out
    assert main([target, "--json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["handlers"]["HOP"]["verdict"] == "ok"
    assert data["handlers"]["HOP"]["edges"][0]["delay"] == [1.0, 4.5]

    mod = tmp_path / "broken_torch_corpus_mod.py"
    mod.write_text(
        "import torch\n"
        "from repro_torch.api import Config, SimProgram\n"
        "def make_program():\n"
        "    prog = SimProgram('broken', config=Config(max_emit=1))\n"
        "    @prog.handler('A', lookahead=9.0, emits=True)\n"
        "    def a(state, t, arg):\n"
        "        e = torch.full((1, 6), -1.0)\n"
        "        e[0, 0] = 1.0\n"
        "        e[0, 1] = 0.0\n"
        "        return state, e\n"
        "    prog.schedule(0.0, 'A')\n"
        "    return prog.example_state(torch.tensor(0))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert main(["broken_torch_corpus_mod:make_program", "--strict"]) == 1
    assert main(["broken_torch_corpus_mod:make_program"]) == 0
    with pytest.raises(SystemExit):
        main(["no_colon_here"])


def _report_fields(report):
    data = json.loads(report.to_json())
    data["findings"] = sorted((f["severity"], f["pass_name"], f["handler"])
                              for f in data["findings"])
    return data


# Fields where the port's report may legitimately differ from JAX's
# (the int64-carried u32 hashes against JAX's u32): none of the six
# targets has one, so each report must equal JAX's field for field.
DIFFERING_FIELDS: dict = {}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_report_parity_with_jax(name, jax_jit_rule):
    """Handlers (type id, lookahead, kind, verdict, min delay, fan-out,
    arg use, ν rows, every edge's delay, arg0 and conditional flag),
    reachable, dead, the word count, the dense codes and the finding
    keys, each equal to JAX's."""
    make_t, make_j = TARGETS[name]
    got = _report_fields(analyze(make_t()))
    want = _report_fields(janalyze(make_j()))
    for field in DIFFERING_FIELDS.get(name, ()):
        got.pop(field), want.pop(field)
    assert got == want


def _random_leaf(rng, x):
    shape = tuple(x.shape)
    if x.dtype == torch.int64:  # the int64-carried u32 leaves
        return torch.from_numpy(rng.integers(0, 2**32, shape))
    if x.dtype == torch.int32:
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, shape).astype(np.int32))
    if x.dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    return torch.from_numpy(rng.normal(0, 100, shape).astype(np.float32))


# Valid entity ids for the handlers that index state by arg[0].
_ENTITIES = {"phold": 8, "mmc": 4}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_emitted_rows_lie_inside_the_bounds(name):
    """Soundness by execution: each emitting handler run eagerly on 64
    seeded random states, times and args; every emitted row's delay,
    type and arg[0] lie inside the port's bounds for that row."""
    prog = TARGETS[name][0]()
    report = analyze(prog)
    rng = np.random.default_rng(0)
    checked = 0
    for spec in prog._specs:
        node = report.nodes[spec.name]
        if not spec.emits:
            continue
        for _ in range(64):
            state = tree_map(lambda x: _random_leaf(rng, x),
                             prog._example_state)
            t = torch.tensor(np.float32(rng.integers(0, 4000) * 0.25
                                        if rng.random() < 0.8
                                        else rng.uniform(0, 1e7)))
            arg = torch.from_numpy(rng.normal(0, 1e3, 4).astype(np.float32))
            if name in _ENTITIES:
                arg[0] = float(rng.integers(0, _ENTITIES[name]))
                arg[1] = float(rng.integers(0, 2))
            _, emits = spec.fn(state, t, arg)
            for r, (d_lo, d_hi, t_lo, t_hi, a_lo, a_hi) in enumerate(
                    node.row_bounds):
                row = emits[r].double().tolist()
                assert d_lo <= row[0] <= d_hi, (spec.name, r, row)
                assert t_lo <= row[1] <= t_hi, (spec.name, r, row)
                assert a_lo <= row[2] <= a_hi, (spec.name, r, row)
                checked += 1
    assert checked == 0 if name in ("poc", "wireless") else checked >= 64


# ---------------------------------------------------------------------------
# static against profiled hot words, and hot_words="static"
# ---------------------------------------------------------------------------

def _word_support(result, codec):
    counts = np.asarray(result.word_counts)
    return {tuple(codec.decode(c)) for c in np.nonzero(counts)[0]}


def test_phold_static_words_superset_of_profiled():
    prog = tphold.make_program()
    report = analyze(prog)
    res = prog.build(device="cpu").run(tphold.initial_state(8), until=20.0)
    codec = DenseCodec(len(prog), prog.config.max_batch_len)
    support = _word_support(res, codec)
    assert support  # the run really composed batches
    assert support <= {tuple(w) for w in report.reachable_words}


def test_serving_static_words_superset_of_profiled():
    cfg = Config(max_batch_len=4, capacity=1024, max_emit=2)
    prog = tsc.build_admission_program(num_slots=4, num_requests=24,
                                       config=cfg)
    prog.example_state(tsc.initial_state(4))
    report = analyze(prog)
    res = prog.build(device="cpu").run(tsc.initial_state(4))
    codec = DenseCodec(len(prog), prog.config.max_batch_len)
    support = _word_support(res, codec)
    assert support
    assert support <= {tuple(w) for w in report.reachable_words}


def test_open_serving_stream_matches_static_reachability():
    cfg = Config(max_batch_len=4, capacity=1024, max_emit=2)
    prog = tsc.build_open_admission_program(num_slots=4, num_requests=16,
                                            config=cfg)
    prog.example_state(tsc.initial_state(4))
    report = analyze(prog)
    assert "ARRIVE" in report.reachable and not report.dead
    src = PoissonSource(rate=1.0, n=16, grid=0.25, type_id=0, seed=3)
    res = prog.build(device="cpu").run(tsc.initial_state(4), arrivals=src)
    assert res.ingested == 16
    codec = DenseCodec(len(prog), prog.config.max_batch_len)
    assert _word_support(res, codec) <= {
        tuple(w) for w in report.reachable_words}


def test_static_hot_words_order_matches_dense_codes():
    prog = tphold.make_program()
    words = analyze(prog).static_hot_words(3)
    codec = DenseCodec(len(prog), prog.config.max_batch_len)
    codes = [codec.encode(list(w)) for w in words]
    assert codes == sorted(codes) and words[0] == (0,)
    # Over the admission scenario's 9,840 reachable words: the first 32
    # dense codes, in order.
    report = analyze(tsc.make_program())
    hot = report.static_hot_words()
    assert report.reachable_word_codes[:32] == list(range(32))
    assert hot == [tuple(DenseCodec(3, 8).decode(c)) for c in range(32)]
    # The lazy enumeration (no word list) gives the same words.
    report.reachable_words = None
    assert report.static_hot_words(5) == hot[:5]


def test_fused_static_build_is_bit_identical():
    """hot_words='static' is a pure hot-set selection: bit-identical
    state, batches and word counts against switch and the default fused
    build."""
    state0 = tphold.initial_state(6)

    def run(**kw):
        prog = tphold.build_program(num_lps=6, t_stop=14.0)
        prog.example_state(state0)
        return prog.build(device="cpu", **kw).run(state0)

    base = run()
    for kw in (dict(dispatch_mode="fused"),
               dict(dispatch_mode="fused", hot_words="static")):
        tq.COUNTS.clear()
        res = run(**kw)
        assert torch.equal(res.state["counts"], base.state["counts"])
        assert int(res.state["checksum"]) == int(base.state["checksum"])
        assert (res.events, res.batches) == (base.events, base.batches)
        np.testing.assert_array_equal(res.word_counts, base.word_counts)
        assert tq.COUNTS["fused_hot"] == res.batches  # 4 words, all hot


def test_checked_static_build_analyzes_once(monkeypatch):
    """build(check=..., hot_words='static') takes its hot set from the
    check's report: one analysis, and the same hot set as an unchecked
    build."""
    import repro_torch.analysis as tanalysis

    calls = []
    real = tanalysis.analyze

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tanalysis, "analyze", counted)
    state0 = tphold.initial_state(6)
    hot = {}
    for check in ("off", "error"):
        calls.clear()
        prog = tphold.build_program(num_lps=6, t_stop=14.0)
        prog.example_state(state0)
        sim = prog.build(device="cpu", dispatch_mode="fused",
                         hot_words="static", check=check)
        assert len(calls) == 1, check
        hot[check] = sim.engine.hot_words
    assert hot["error"] == hot["off"]


def test_static_hot_words_requires_example_state():
    prog = tphold.build_program(num_lps=4)
    with pytest.raises(ValueError, match="example_state"):
        prog.build(device="cpu", dispatch_mode="fused", hot_words="static")


# ---------------------------------------------------------------------------
# codec words_over
# ---------------------------------------------------------------------------

def test_words_over_subset_matches_enumeration():
    codec = DenseCodec(3, 3)
    full = dict(codec.enumerate_words())
    sub = list(codec.words_over([0, 2]))
    for code, word in sub:
        assert full[code] == word
    codes = [c for c, _ in sub]
    assert codes == sorted(codes)
    assert len(sub) == 2 + 4 + 8
    assert all(set(w) <= {0, 2} for _, w in sub)
    assert list(DenseCodec(2, 4).words_over([0, 1])) == list(
        DenseCodec(2, 4).enumerate_words())
    with pytest.raises(ValueError, match="out of range"):
        list(codec.words_over([3]))


def test_ival_is_the_jax_domain():
    """The pure-numpy domain is JAX's, function for function."""
    from repro_torch.analysis import absint as tabs

    a = Ival(np.array([-3.0, 2.0]), np.array([5.0, 9.0]))
    b = Ival(np.array([2.0, -1.0]), np.array([4.0, 3.0]))
    ja = jabsint.Ival(a.lo, a.hi)
    jb = jabsint.Ival(b.lo, b.hi)
    for name in ("_mul_iv", "_hull"):
        got, want = getattr(tabs, name)(a, b), getattr(jabsint, name)(ja, jb)
        np.testing.assert_array_equal(got.lo, want.lo)
        np.testing.assert_array_equal(got.hi, want.hi)
    for integer in (False, True):
        got = tabs._div_iv(a, b, integer=integer)
        want = jabsint._div_iv(ja, jb, integer=integer)
        np.testing.assert_array_equal(got.lo, want.lo)
        for pymod in (False, True):
            got = tabs._rem_iv(a, b, integer=integer, pymod=pymod)
            want = jabsint._rem_iv(ja, jb, integer=integer, pymod=pymod)
            np.testing.assert_array_equal(got.lo, want.lo)
            np.testing.assert_array_equal(got.hi, want.hi)
    for op in ("lt", "le", "gt", "ge", "eq", "ne"):
        np.testing.assert_array_equal(tabs._cmp(a, b, op).lo,
                                      jabsint._cmp(ja, jb, op).lo)
    got = tabs._guard(Ival(np.array([0.0, -1.0]), np.array([3e9, 5.0])),
                      (2,), torch.int32)
    want = jabsint._guard(jabsint.Ival(np.array([0.0, -1.0]),
                                       np.array([3e9, 5.0])),
                          np.zeros(2, np.int32))
    np.testing.assert_array_equal(got.lo, want.lo)
    np.testing.assert_array_equal(got.hi, want.hi)
