"""The ``fused`` dispatch of ``repro_torch`` against ``repro``'s.

Mirrors ``tests/test_fused_dispatch.py``: the three dispatch modes are
bit-equivalent on every window of a small alphabet (and equal to JAX's
dispatchers on the same window), the hot-slot table is JAX's for the
same hot words, the hot-word validation and knob errors, the default hot
set, ``hot_words_from_counts``'s ranking, and hot words given by name
through ``build``.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import poc as jpoc
from repro.core import composer as jcomp
from repro.core.codec import DenseCodec as JCodec
from repro.core.events import ARG_WIDTH
from repro.core.events import EventRegistry as JRegistry
from repro.core.events import emits_events as j_emits
from repro.core.program import Config as JConfig
from repro_torch.api import Config as TConfig
from repro_torch.core import composer as tcomp
from repro_torch.core import queue as tq
from repro_torch.core.codec import DenseCodec as TCodec
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.events import EventRegistry as TRegistry
from repro_torch.core.events import emits_events as t_emits
from repro_torch.examples import poc as tpoc


def _jax_registry():
    """inc emits nothing; spawn emits one event."""
    reg = JRegistry()

    def inc(state, t, arg):
        return state + jnp.float32(1.0) + arg[0]

    @j_emits
    def spawn(state, t, arg):
        emit = jnp.zeros((1, 2 + ARG_WIDTH), jnp.float32)
        emit = emit.at[0, 0].set(t + 1.5)
        emit = emit.at[0, 1].set(0.0)
        return state * jnp.float32(2.0), emit

    reg.register("inc", inc, lookahead=1.0)
    reg.register("spawn", spawn, lookahead=1.0)
    return reg.freeze()


def _torch_registry():
    """The same two types in torch."""
    reg = TRegistry()

    def inc(state, t, arg):
        return state + 1.0 + arg[0]

    @t_emits
    def spawn(state, t, arg):
        emit = torch.zeros((1, 2 + ARG_WIDTH), dtype=torch.float32)
        emit[0, 0] = t + 1.5
        emit[0, 1] = 0.0
        return state * 2.0, emit

    reg.register("inc", inc, lookahead=1.0)
    reg.register("spawn", spawn, lookahead=1.0)
    return reg.freeze()


def _windows(codec, rng):
    """One window per word, random times and args: (ts, types, args,
    length) as numpy."""
    k = codec.max_len
    for code, word in codec.enumerate_words():
        tys = np.zeros((k,), np.int32)
        tys[:len(word)] = word
        ts = np.sort(rng.uniform(0, 5, k)).astype(np.float32)
        args = rng.uniform(0, 1, (k, ARG_WIDTH)).astype(np.float32)
        yield code, ts, tys, args, len(word)


@pytest.mark.parametrize("hot", [[(0,), (0, 0), (1, 0)], [(1, 1, 1)], []])
def test_three_modes_bit_equivalent_per_window(hot):
    jreg, treg = _jax_registry(), _torch_registry()
    jc, tc = JCodec(2, 3), TCodec(2, 3)
    jsw = jcomp.build_switch_dispatcher(jreg, jc, max_emit=1)
    sw = tcomp.build_switch_dispatcher(treg, tc, max_emit=1)
    ma = tcomp.build_masked_dispatcher(treg, tc, max_emit=1)
    fu = tcomp.build_fused_dispatcher(treg, tc, hot, max_emit=1)
    rng = np.random.default_rng(0)
    tq.COUNTS.clear()
    for code, ts, tys, args, n in _windows(tc, rng):
        s_j, e_j = jsw(jnp.int32(code), jnp.float32(3.0), jnp.asarray(ts),
                       jnp.asarray(tys), jnp.asarray(args))
        t_ts, t_args = torch.from_numpy(ts), torch.from_numpy(args)
        state0 = torch.tensor(3.0)
        runs = [sw(code, state0, t_ts, t_args),
                ma(state0, t_ts, tys.tolist(), t_args, n),
                fu(code, state0, t_ts, tys.tolist(), t_args, n)]
        for s, e in runs:
            np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
            np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))
    assert tq.COUNTS["fused_hot"] == len(hot)
    assert tq.COUNTS["fused_fallback"] == tc.num_batches - len(hot)


def test_hot_slot_table_matches_jax():
    hot = [(1,), (0, 1), (1,)]
    jfu = jcomp.build_fused_dispatcher(_jax_registry(), JCodec(2, 2), hot,
                                       max_emit=1)
    tfu = tcomp.build_fused_dispatcher(_torch_registry(), TCodec(2, 2), hot,
                                       max_emit=1)
    assert tfu.hot_words == jfu.hot_words == ((1,), (0, 1))
    assert tfu.num_hot == jfu.num_hot == 2
    assert tfu.num_batches == jfu.num_batches
    assert tfu.hot_slot_table.dtype == np.int32
    np.testing.assert_array_equal(tfu.hot_slot_table,
                                  np.asarray(jfu.hot_slot_table))


@pytest.mark.parametrize("bad,match", [
    ([(0, 0, 0)], "has length 3"),
    ([(5,)], "names type id 5"),
    ([()], "has length 0"),
])
def test_fused_validates_hot_words(bad, match):
    for build, reg, codec in (
            (jcomp.build_fused_dispatcher, _jax_registry(), JCodec(2, 2)),
            (tcomp.build_fused_dispatcher, _torch_registry(), TCodec(2, 2))):
        with pytest.raises(ValueError, match=match):
            build(reg, codec, bad)
    # Duplicates collapse rather than error.
    fu = tcomp.build_fused_dispatcher(_torch_registry(), TCodec(2, 2),
                                      [(0,), (0,)], max_emit=1)
    assert fu.num_hot == 1


def test_default_hot_set_covers_small_alphabets():
    """num_batches <= 32: the default hot set is the whole code space
    (the JAX engine's), so the fallback never fires."""
    jp = jpoc.build_program(iters=8, config=JConfig(max_batch_len=3))
    tp = tpoc.build_program(iters=8, config=TConfig(max_batch_len=3))
    jeng = jp.build(backend="device", dispatch_mode="fused").engine
    teng = tp.build(backend="device", device="cpu",
                    dispatch_mode="fused").engine
    assert teng.hot_words == tuple(jeng.hot_words)
    assert len(teng.hot_words) == teng.codec.num_batches == 14
    assert (teng._dispatch_fused.hot_slot_table < len(teng.hot_words)).all()
    # A larger alphabet keeps the first 32 dense codes.
    big = TRegistry()
    for name in "abcd":
        big.register(name, lambda s, t, a: s, lookahead=1.0)
    eng = DeviceEngine(big, max_batch_len=3, capacity=64, device="cpu",
                       dispatch_mode="fused")
    assert len(eng.hot_words) == 32
    assert eng.hot_words == tuple(tuple(eng.codec.decode(c))
                                  for c in range(32))


def test_hot_words_from_counts_ranking_matches_jax():
    codec_j, codec_t = JCodec(2, 2), TCodec(2, 2)
    counts = np.zeros((codec_t.num_batches,), np.int64)
    counts[codec_t.encode([0, 1])] = 5
    counts[codec_t.encode([1])] = 9
    counts[codec_t.encode([0])] = 5
    want = jcomp.hot_words_from_counts(counts, codec_j, 2)
    assert want == [(1,), (0,)]     # the tie goes to the smaller code
    assert tcomp.hot_words_from_counts(counts, codec_t, 2) == want
    assert tcomp.hot_words_from_counts(torch.from_numpy(counts), codec_t,
                                       2) == want
    assert tcomp.hot_words_from_counts(counts, codec_t, 8) == \
        jcomp.hot_words_from_counts(counts, codec_j, 8)
    assert len(tcomp.hot_words_from_counts(counts, codec_t, 8)) == 3
    table = {int(codec_t.encode([1])): 9, int(codec_t.encode([0])): 5,
             int(codec_t.encode([1, 1])): 0}
    assert tcomp.hot_words_from_counts(table, codec_t, 8) == \
        jcomp.hot_words_from_counts(table, codec_j, 8) == [(1,), (0,)]


def test_hot_words_by_name_through_build():
    evs = [(float(t), ty) for t, ty in enumerate([0, 0, 1, 0])]
    kw = dict(dispatch_mode="fused",
              hot_words=[("Increment", "Increment"), ("Set",)])
    jsim = jpoc.build_program(
        iters=8, config=JConfig(max_batch_len=2)).build(backend="device",
                                                         **kw)
    tsim = tpoc.build_program(
        iters=8, config=TConfig(max_batch_len=2)).build(backend="device",
                                                         device="cpu", **kw)
    assert tsim.engine.hot_words == tuple(jsim.engine.hot_words) == \
        ((0, 0), (1,))
    jres = jsim.run(jpoc.initial_state(), events=evs)
    tq.COUNTS.clear()
    tres = tsim.run(tpoc.initial_state(), events=evs)
    assert int(tres.state) == int(jres.state)
    assert tres.batches == jres.batches
    np.testing.assert_array_equal(tres.word_counts,
                                  np.asarray(jres.word_counts))
    assert tq.COUNTS["fused_hot"] + tq.COUNTS["fused_fallback"] == \
        tres.batches


def test_knob_validation():
    prog = tpoc.build_program(iters=4)
    with pytest.raises(ValueError, match="hot_words only applies"):
        prog.build(device="cpu", hot_words=[(0,)])
    with pytest.raises(ValueError, match="hot_words only applies"):
        DeviceEngine(_torch_registry(), max_batch_len=2, capacity=32,
                     device="cpu", hot_words=[(0,)])
    with pytest.raises(ValueError, match="dispatch_mode"):
        DeviceEngine(_torch_registry(), max_batch_len=2, capacity=32,
                     device="cpu", dispatch_mode="vectorized")
    with pytest.raises(ValueError, match="example_state"):
        prog.build(device="cpu", dispatch_mode="fused", hot_words="static")
    with pytest.raises(ValueError, match="unknown hot_words"):
        prog.build(device="cpu", dispatch_mode="fused", hot_words="hot")
    # With a template declared, the static hot set (PoC's 30 reachable
    # words at windows of 4, the first 32 dense codes) builds and runs.
    prog.example_state(tpoc.initial_state())
    sim = prog.build(device="cpu", dispatch_mode="fused", hot_words="static")
    assert [tuple(w) for w in sim.engine.hot_words] == [
        tuple(tpoc.build_program(4).build(device="cpu").engine.codec.decode(c))
        for c in range(30)]
    evs = tpoc.schedule_poc_events(40, 0.3, seed=1)
    res = sim.run(tpoc.initial_state(), events=evs)
    base = prog.build(device="cpu").run(tpoc.initial_state(), events=evs)
    assert int(res.state) == int(base.state) and res.batches == base.batches


def test_dispatch_attr_always_available():
    prog = tpoc.build_program(iters=8, config=TConfig(max_batch_len=2))
    for mode in ("switch", "masked", "fused"):
        eng = prog.build(backend="device", device="cpu",
                         dispatch_mode=mode).engine
        assert callable(eng.dispatch)
        assert eng.dispatch.num_batches == eng.codec.num_batches
