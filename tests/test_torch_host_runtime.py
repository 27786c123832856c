"""The host runtime of ``repro_torch`` (schedulers, composers, the paper
codec) against ``repro``'s, case by case.

The counterparts of ``tests/test_core_engine.py``'s host tests (both
codecs x three modes on the PoC oracle, the lookahead limit, emission
anchoring, the causality error, the rollback model and the violation
predicate, the eager composer), each run through both packages with the
same registry and the same seeds; the port with ``device="cpu",
jit_handlers=False``.  ``PaperCodec`` is held to JAX's exhaustively at
small ``(|Σ|, n)``, ``encode_torch`` to ``encode_jnp``.  The compile
route is checked with a recording stand-in for ``torch.compile`` (a real
Inductor compile takes tens of seconds on one core): each composed word,
or each handler unbatched, goes to it whole, with ``fullgraph=True``,
and a frame it cannot compile raises, naming the word.  Tolerance:
exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import poc as jpoc
from repro.core import codec as jcodec
from repro.core import EventRegistry as JReg
from repro.core import HostEventQueue as JQueue
from repro.core import Simulator as JSim
from repro.core import emits_events as j_emits
from repro.core import extract_window as j_extract
from repro.core import extract_window_presorted as j_presorted
from repro.core import run_unbatched as j_unbatched
from repro.core.scheduler import ConservativeScheduler as JCons
from repro.core.scheduler import SpeculativeScheduler as JSpec
from repro_torch import poc as tpoc
from repro_torch.core import EventRegistry as TReg
from repro_torch.core import HostEventQueue as TQueue
from repro_torch.core import Simulator as TSim
from repro_torch.core import emits_events as t_emits
from repro_torch.core import extract_window as t_extract
from repro_torch.core import extract_window_presorted as t_presorted
from repro_torch.core import run_unbatched as t_unbatched
from repro_torch.core import codec as tcodec
from repro_torch.core import queue as tq
from repro_torch.core.scheduler import ConservativeScheduler as TCons
from repro_torch.core.scheduler import SpeculativeScheduler as TSpec
from repro_torch.examples import phold as tphold

ITERS = 64
TYPES_MIXED = [0, 1, 0, 0, 1, 1, 0, 0, 1]
CPU = dict(device="cpu", jit_handlers=False)


def _schedule_all(sim, types):
    for t, ty in enumerate(types):
        sim.queue.push(float(t), int(ty))


@pytest.mark.parametrize("mode", ["conservative", "speculative", "unbatched"])
@pytest.mark.parametrize("codec", ["dense", "paper"])
def test_host_modes_match_oracle_and_jax(mode, codec):
    jsim = JSim(jpoc.build_registry(iters=ITERS), max_batch_len=3,
                codec=codec)
    tsim = TSim(tpoc.build_registry(iters=ITERS), max_batch_len=3,
                codec=codec, **CPU)
    _schedule_all(jsim, TYPES_MIXED)
    _schedule_all(tsim, TYPES_MIXED)
    js, jst = jsim.run(jpoc.initial_state(), mode=mode)
    ts, tst = tsim.run(tpoc.initial_state(), mode=mode)
    assert int(ts) == int(js) == tpoc.reference_final_sum(TYPES_MIXED, ITERS)
    assert dataclass_fields(tst) == dataclass_fields(jst)
    if mode != "unbatched":
        assert tst.batches_executed == -(-len(TYPES_MIXED) // 3)


def dataclass_fields(stats) -> dict:
    return {k: getattr(stats, k) for k in
            ("events_executed", "batches_executed", "rollbacks",
             "final_time", "batch_length_hist")}


def test_batched_equals_unbatched_random():
    rng = np.random.default_rng(0)
    types = [int(t) for t in (rng.random(40) < 0.4).astype(int)]
    out = []
    for mode in ("conservative", "unbatched"):
        sim = TSim(tpoc.build_registry(iters=ITERS), max_batch_len=4, **CPU)
        _schedule_all(sim, types)
        out.append(int(sim.run(tpoc.initial_state(), mode=mode)[0]))
    assert out[0] == out[1] == tpoc.reference_final_sum(types, ITERS)


@pytest.mark.parametrize("la,times", [(1.5, [0.0, 1.0, 2.0, 3.0]),
                                      (0.25, [0.0, 0.25, 0.5, 0.75]),
                                      (float("inf"), [0.0, 9.0, 9.0, 10.0])])
def test_lookahead_window_limits_batch(la, times):
    got = []
    for reg_cls, q_cls, extract in ((JReg, JQueue, j_extract),
                                    (TReg, TQueue, t_extract)):
        reg = reg_cls()
        reg.register("A", lambda s, t, a: s + 1, lookahead=la)
        reg.freeze()
        q = q_cls()
        for t in times:
            q.push(t, 0)
        got.append([ev.time for ev in extract(q, reg, max_len=4)])
        got.append([ev.time for ev in extract(q, reg, max_len=4,
                                              t_cap=times[-1] - 0.5)])
    assert got[:2] == got[2:]
    if la == 1.5:
        assert got[2] == [0.0, 1.0]


def test_extract_window_presorted_matches_jax():
    rng = np.random.default_rng(3)
    for trial in range(20):
        regs = []
        for reg_cls in (JReg, TReg):
            reg = reg_cls()
            for i, la in enumerate([0.5, 1.0, float("inf")]):
                reg.register(f"t{i}", lambda s, t, a: s, lookahead=la)
            regs.append(reg.freeze())
        q = TQueue()
        times = np.sort(rng.integers(0, 12, 6)) * 0.25
        for t in times:
            q.push(float(t), int(rng.integers(0, 3)))
        evs = sorted(q._heap)
        evs = [e for (_t, _s, e) in evs]
        for k in (1, 3, 6):
            want = j_presorted(evs, regs[0], k)
            assert t_presorted(evs, regs[1], k) == want, (trial, k)
    assert t_presorted([], regs[1], 4) == 0


def _self_scheduling(reg_cls, emits):
    reg = reg_cls()

    @emits
    def a(state, t, arg):
        return state + 1, [(2.0, 0, None)]

    reg.register("A", a, lookahead=2.0)
    return reg


def test_emitted_events_are_scheduled():
    jsim = JSim(_self_scheduling(JReg, j_emits), max_batch_len=2)
    tsim = TSim(_self_scheduling(TReg, t_emits), max_batch_len=2, **CPU)
    jsim.queue.push(0.0, 0)
    tsim.queue.push(0.0, 0)
    tq.COUNTS.clear()
    ts, tst = tsim.run(torch.tensor(0, dtype=torch.int32), max_events=5)
    js, jst = jsim.run(jnp.int32(0), max_events=5)
    assert int(ts) == int(js) == 5
    assert tst.final_time == jst.final_time == 8.0
    # Python-number emissions need no read of the device.
    assert tq.COUNTS["host_syncs"] == 0


def _bad(reg_cls, emits):
    reg = reg_cls()

    @emits
    def bad(state, t, arg):
        return state, [(-5.0, 0, None)]  # violates its declared lookahead

    reg.register("Bad", bad, lookahead=10.0)
    return reg


def test_causality_check_fires_with_jax_message():
    msgs = []
    for sim_cls, reg_cls, emits, q_cls, cons, state, kw in (
            (JSim, JReg, j_emits, JQueue, JCons, jnp.int32(0), {}),
            (TSim, TReg, t_emits, TQueue, TCons, torch.tensor(0), CPU)):
        sim = sim_cls(_bad(reg_cls, emits), max_batch_len=2, **kw)
        sched = cons(sim.registry, sim.composer, check_causality=True)
        q = q_cls()
        q.push(0.0, 0)
        q.push(1.0, 0)
        with pytest.raises(RuntimeError, match="causality") as err:
            sched.run(state, q)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _rollback_model(reg_cls, emits, absorber_shift):
    reg = reg_cls()

    @emits
    def emitter(state, t, arg):
        # lands at t+0.5, before the later events of the batch
        return state * 2 + 1, [(0.5, 1, None)]

    def absorber(state, t, arg):
        return state * 3 + absorber_shift

    reg.register("E", emitter, lookahead=0.5)
    reg.register("Ab", absorber, lookahead=10.0)
    return reg


def _rollback_queue(q_cls):
    q = q_cls()
    q.push(0.0, 0)
    q.push(1.0, 1)
    q.push(2.0, 1)
    return q


@pytest.mark.parametrize("shift", [0, 1])
def test_speculative_rollback_matches_sequential_and_jax(shift):
    """shift 1: the absorber does not commute with the emitter, the
    violation predicate's regression case (one rollback)."""
    jreg = _rollback_model(JReg, j_emits, shift)
    treg = _rollback_model(TReg, t_emits, shift)
    jsim = JSim(jreg, max_batch_len=3)
    tsim = TSim(treg, max_batch_len=3, **CPU)
    js, jst = JSpec(jsim.registry, jsim.composer).run(
        jnp.int32(0), _rollback_queue(JQueue), max_events=16)
    ts, tst = TSpec(tsim.registry, tsim.composer).run(
        torch.tensor(0, dtype=torch.int32), _rollback_queue(TQueue),
        max_events=16)
    seq, _ = t_unbatched(treg, torch.tensor(0, dtype=torch.int32),
                         _rollback_queue(TQueue), max_events=16, **CPU)
    jseq, _ = j_unbatched(jreg, jnp.int32(0), _rollback_queue(JQueue),
                          max_events=16)
    assert int(ts) == int(js) == int(seq) == int(jseq)
    assert dataclass_fields(tst) == dataclass_fields(jst)
    assert tst.rollbacks == 1


def test_window_slack_bounds_speculation():
    jreg = _rollback_model(JReg, j_emits, 1)
    treg = _rollback_model(TReg, t_emits, 1)
    for slack in (0.0, 0.75, 5.0):
        jsim = JSim(jreg, max_batch_len=3)
        tsim = TSim(treg, max_batch_len=3, **CPU)
        js, jst = JSpec(jsim.registry, jsim.composer,
                        window_slack=slack).run(
            jnp.int32(0), _rollback_queue(JQueue))
        ts, tst = TSpec(tsim.registry, tsim.composer,
                        window_slack=slack).run(
            torch.tensor(0, dtype=torch.int32), _rollback_queue(TQueue))
        assert int(ts) == int(js), slack
        assert dataclass_fields(tst) == dataclass_fields(jst), slack


def _anchor_model(reg_cls, emits):
    reg = reg_cls()

    @emits
    def emitter(state, t, arg):
        return state * 2 + 1, [(3.0, 1, None)]

    def absorber(state, t, arg):
        return state * 3 + 1

    reg.register("E", emitter, lookahead=3.0)
    reg.register("Ab", absorber, lookahead=10.0)
    return reg


def test_conservative_emissions_anchor_at_emitting_event():
    jsim = JSim(_anchor_model(JReg, j_emits), max_batch_len=2)
    tsim = TSim(_anchor_model(TReg, t_emits), max_batch_len=2, **CPU)
    for sim in (jsim, tsim):
        sim.queue.push(0.0, 0)
        sim.queue.push(2.0, 1)
    js, jst = jsim.run(jnp.int32(0), mode="conservative", max_events=8)
    ts, tst = tsim.run(torch.tensor(0, dtype=torch.int32),
                       mode="conservative", max_events=8)
    assert int(ts) == int(js)
    # batch [E@0, Ab@2] emits at 0+3=3, not at the batch end 2+3=5.
    assert tst.final_time == jst.final_time == 3.0


@pytest.mark.parametrize("codec,composed", [("dense", 6), ("paper", 12)])
def test_eager_composer_precompiles_all(codec, composed):
    tsim = TSim(tpoc.build_registry(iters=ITERS), max_batch_len=2,
                codec=codec, composer="eager",
                state_spec=((), torch.int64), arg_spec=None, **CPU)
    jsim = JSim(jpoc.build_registry(iters=ITERS), max_batch_len=2,
                codec=codec, composer="eager",
                state_spec=jax.ShapeDtypeStruct((), jnp.uint32),
                arg_spec=None)
    assert tsim.composer.num_composed == jsim.composer.num_composed \
        == composed
    assert tsim.composer.trace_count == composed
    _schedule_all(tsim, TYPES_MIXED)
    state, _ = tsim.run(tpoc.initial_state(), mode="conservative")
    assert int(state) == tpoc.reference_final_sum(TYPES_MIXED, ITERS)


# ---------------------------------------------------------------------------
# The paper codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_types,max_len", [(1, 4), (2, 3), (3, 3),
                                                (5, 2)])
def test_paper_codec_matches_jax_exhaustively(num_types, max_len):
    jc = jcodec.PaperCodec(num_types, max_len)
    tc = tcodec.PaperCodec(num_types, max_len)
    assert tc.num_batches == jc.num_batches
    assert tcodec.paper_batch_count(num_types, max_len) \
        == jcodec.paper_batch_count(num_types, max_len)
    assert tcodec.redundant_batch_count(num_types, max_len) \
        == jcodec.redundant_batch_count(num_types, max_len)
    assert list(tc.enumerate_codes()) == list(jc.enumerate_codes())
    for code in jc.enumerate_codes():
        assert tc.decode(code) == jc.decode(code)
    for k in range(1, max_len + 1):
        for word in itertools.product(range(num_types), repeat=k):
            code = jc.encode(list(word))
            assert tc.encode(list(word)) == code
            assert tc.decode(code) == list(word)
            padded = list(word) + [num_types - 1] * (max_len - k)
            want = int(jc.encode_jnp(jnp.asarray(padded, jnp.int32),
                                     jnp.int32(k)))
            got = tc.encode_torch(torch.tensor(padded, dtype=torch.int32),
                                  torch.tensor(k, dtype=torch.int32))
            assert got.dtype == torch.int32 and int(got) == want == code
    for bad in ([], [num_types], [0] * (max_len + 1)):
        with pytest.raises(ValueError):
            tc.encode(bad)
        with pytest.raises(ValueError):
            jc.encode(bad)
    with pytest.raises(ValueError):
        tc.decode(0)
    assert tcodec.make_codec("paper", num_types, max_len) == tc


def test_device_dispatch_refuses_the_paper_codec():
    from repro_torch.core.composer import build_switch_dispatcher

    reg = tpoc.build_registry(iters=4)
    with pytest.raises(TypeError, match="DenseCodec"):
        build_switch_dispatcher(reg, tcodec.PaperCodec(2, 2))


# ---------------------------------------------------------------------------
# The compile route and the public surface
# ---------------------------------------------------------------------------

@pytest.fixture
def recording_compile(monkeypatch):
    """``torch.compile`` replaced by a stand-in that records what it is
    given and returns it uncompiled."""
    seen = []

    def fake(fn, **kw):
        seen.append((fn.__name__, fn.__code__.co_name, kw))
        return fn

    monkeypatch.setattr(torch, "compile", fake)
    return seen


def test_jit_handlers_compiles_each_word_whole(recording_compile):
    prog = tpoc.build_program(iters=4, config=None)
    evs = [(float(t), ty) for t, ty in enumerate([0, 1, 1, 0, 0, 0, 0, 1])]
    for t, ty in evs:
        prog.schedule(t, ("Increment", "Set")[ty])
    sim = prog.build(backend="host", device="cpu")
    res = sim.run(tpoc.initial_state())
    assert int(res.state) == tpoc.reference_final_sum([ty for _, ty in evs],
                                                      4)
    names = [n for n, _, _ in recording_compile]
    assert names == ["batch_Increment_Set_Set_Increment",
                     "batch_Increment_Increment_Increment_Set"]
    assert all(kw == {"fullgraph": True} for _, _, kw in recording_compile)
    # Each word has a code object of its own, named after it.
    assert [c for _, c, _ in recording_compile] == names
    comp = sim.sched.composer
    assert comp.num_composed == 2 and set(comp.compile_seconds) == {
        prog_code for prog_code in comp._programs}
    sim.run(tpoc.initial_state())
    assert len(recording_compile) == 2  # compiled once a word


def test_jit_handlers_compiles_each_handler_unbatched(recording_compile):
    sim = tphold.build_program(num_lps=3, t_stop=3.0).build(
        backend="host", scheduler="unbatched", device="cpu")
    first = sim.run(tphold.initial_state(3))
    again = sim.run(tphold.initial_state(3))
    assert [n for n, _, _ in recording_compile] == ["handler_HOP"]
    assert first.stats() == again.stats()


def test_jit_handlers_eager_composer_compiles_every_code(recording_compile):
    sim = tpoc.build_program(iters=4, config=None).build(
        backend="host", composer="eager", state_spec=((), torch.int64),
        device="cpu")
    assert len(recording_compile) == 2 + 4 + 8 + 16
    # Each word was called once on zeros, the call that compiles it.
    comp = sim.sched.composer
    assert sorted(comp.compile_seconds) == list(range(30))
    assert all(comp.program(c).first_call_s is not None for c in range(30))


def test_failed_compile_raises_and_names_the_word(monkeypatch):
    import torch._dynamo

    def refusing(fn, **kw):
        def call(*args):
            raise torch._dynamo.exc.Unsupported("graph break")
        return call

    monkeypatch.setattr(torch, "compile", refusing)
    prog = tpoc.build_program(iters=4)
    prog.schedule(0.0, "Set")
    sim = prog.build(backend="host", device="cpu")
    with pytest.raises(RuntimeError, match="batch_Set did not compile"):
        sim.run(tpoc.initial_state())
    monkeypatch.setattr(torch._dynamo.config, "suppress_errors", True)
    with pytest.raises(RuntimeError, match="suppress_errors"):
        tpoc.build_program(iters=4).build(
            backend="host", scheduler="unbatched", device="cpu").run(
            tpoc.initial_state(), events=[(0.0, "Set")])


def test_one_host_read_per_emitting_batch():
    sim = tphold.build_program(num_lps=5, t_stop=12.0).build(
        backend="host", **CPU)
    tq.COUNTS.clear()
    res = sim.run(tphold.initial_state(5))
    assert tq.COUNTS["host_syncs"] == res.batches


def test_host_build_needs_cuda_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for sched in ("conservative", "speculative", "unbatched"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tphold.build_program(num_lps=3).build(backend="host",
                                                  scheduler=sched)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(tpoc.build_registry(iters=4))


@pytest.mark.parametrize("kw,match", [
    (dict(backend="device", scheduler="speculative"), "host-backend"),
    (dict(backend="device", jit_handlers=False), "jit_handlers"),
    (dict(backend="device", window_slack=1.0), "window_slack"),
    (dict(backend="device", state_spec=((), torch.int64)), "state_spec"),
    (dict(backend="host", validate="cheap"), "device-backend"),
    (dict(backend="host", scheduler="bogus"), "unknown scheduler"),
    (dict(backend="host", composer="bogus"), "unknown composer"),
    (dict(backend="nowhere"), "unknown backend"),
])
def test_misdirected_knobs_raise_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        tphold.build_program(num_lps=3).build(device="cpu", **kw)


def test_host_run_refuses_device_run_knobs(tmp_path):
    sim = tphold.build_program(num_lps=3).build(backend="host", **CPU)
    with pytest.raises(ValueError, match="device-backend knobs"):
        sim.run(tphold.initial_state(3), checkpoint_every=4,
                checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unbounded heap"):
        sim.run(tphold.initial_state(3), backpressure="shed",
                arrivals=tpoc_source())


def tpoc_source():
    from repro_torch.api import PoissonSource

    return PoissonSource(1.0, 4, seed=0, grid=0.25, type_id=0)


def test_public_surface_matches_jax():
    import repro.api
    import repro.core
    import repro_torch.api
    import repro_torch.core
    from repro.core.program import RunResult as JResult
    from repro_torch.core.program import RunResult as TResult

    assert repro_torch.core.__all__ == repro.core.__all__
    assert set(repro.api.__all__) - set(repro_torch.api.__all__) == set()
    j = JResult(state=None, events=3, batches=2, dropped=0, final_time=1.5,
                rollbacks=1)
    t = TResult(state=None, events=3, batches=2, dropped=0, final_time=1.5,
                rollbacks=1)
    assert t.stats() == j.stats()
    for pkg in (jpoc, tpoc):
        assert (pkg.DEFAULT_ITERS, pkg.PAPER_ITERS) == (100_000, 1_000_000)
    assert tpoc.s_max(4, 0.3) == jpoc.s_max(4, 0.3)
    assert tpoc.s_max(4, 0.0) == 4.0 and tpoc.s_max(4, 1.0) == 1.0
    tp = tpoc.make_program()
    jp = jpoc.make_program()
    assert (tp.names, len(tp), tp.frozen) == (jp.names, len(jp), jp.frozen)
    tp.build(backend="host", **CPU)
    assert tp.frozen


def test_push_all_pops_as_one_push_after_another():
    rng = np.random.default_rng(5)
    items = [(float(t), int(ty), None) for t, ty in
             zip(rng.integers(0, 6, 40) * 0.5, rng.integers(0, 3, 40))]
    one, bulk = TQueue(), TQueue()
    one.push(1.0, 2)
    bulk.push(1.0, 2)
    for it in items:
        one.push(*it)
    bulk.push_all(items)
    assert bulk.push_count == one.push_count == 41
    got = [bulk.pop() for _ in range(len(bulk))]
    assert got == [one.pop() for _ in range(len(one))]
    assert [e.key() for e in got] == sorted(e.key() for e in got)
