"""Same-type run vectorization of ``repro_torch`` against ``repro``'s.

``make_run_handler`` and ``make_masked_run_handler`` (``torch.func.
vmap`` plus ``index_select`` / ``index_copy_``) against
``repro.core.vectorize``'s on the same seeded numpy state, with masked
lanes and the entity dimension on axis 0 and 1; ``is_single_type_run``;
and an entity program whose vmapped run path and sequential path give
the same state, both equal to JAX's.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import vectorize as jvec
from repro.core.program import Config as JConfig
from repro.core.program import SimProgram as JProgram
from repro_torch.api import Config as TConfig
from repro_torch.api import SimProgram as TProgram
from repro_torch.core import queue as tq
from repro_torch.core import vectorize as tvec
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.program import CompiledSim

from test_torch_engine import assert_run_parity

N = 10


def _state(rng, state_axis):
    """Two leaves with the entity dimension (N) on ``state_axis``."""
    shape_i = (N, 3) if state_axis == 0 else (3, N)
    return {
        "count": rng.integers(-50, 50, shape_i).astype(np.int32),
        "level": rng.uniform(-4, 4, (N,) if state_axis == 0 else (2, N))
        .astype(np.float32),
    }


def _local_jax(es, t, arg):
    return {"count": es["count"] * 3 + 1,
            "level": es["level"] + t + arg[1]}


def _local_torch(es, t, arg):
    return {"count": es["count"] * 3 + 1,
            "level": es["level"] + t + arg[1]}


def _as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _as_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _assert_same(tstate, jstate):
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]), err_msg=k)


def _lanes(rng, k):
    ids = rng.permutation(N)[:k].astype(np.int32)
    ts = rng.uniform(0, 9, k).astype(np.float32)
    args = rng.uniform(-1, 1, (k, 4)).astype(np.float32)
    args[:, 0] = ids
    return ids, ts, args


@pytest.mark.parametrize("state_axis", [0, 1])
def test_run_handler_matches_jax(state_axis):
    rng = np.random.default_rng(3)
    state = _state(rng, state_axis)
    ids, ts, args = _lanes(rng, 4)
    jrun = jvec.make_run_handler(_local_jax, state_axis=state_axis)
    trun = tvec.make_run_handler(_local_torch, state_axis=state_axis)
    want = jrun(_as_jax(state), jnp.asarray(ts), jnp.asarray(args),
                jnp.asarray(ids))
    got = trun(_as_torch(state), torch.from_numpy(ts),
               torch.from_numpy(args), torch.from_numpy(ids))
    _assert_same(got, want)


@pytest.mark.parametrize("state_axis", [0, 1])
@pytest.mark.parametrize("mask", [
    [True, True, True, True, True],
    [True, True, False, False, False],
    [False, True, False, True, False],
    [False, False, False, False, False],
    [True, False, False, False, False],
])
def test_masked_run_handler_matches_jax(state_axis, mask):
    rng = np.random.default_rng(sum(mask) + 7 * state_axis)
    state = _state(rng, state_axis)
    ids, ts, args = _lanes(rng, 5)
    # A masked lane's id may be anything, even past the end: it is
    # neither gathered nor scattered.
    ids = np.where(mask, ids, 1000 + np.arange(5)).astype(np.int32)
    m = np.asarray(mask)
    jrun = jvec.make_masked_run_handler(_local_jax, state_axis=state_axis)
    trun = tvec.make_masked_run_handler(_local_torch, state_axis=state_axis)
    want = jrun(_as_jax(state), jnp.asarray(ts), jnp.asarray(args),
                jnp.asarray(ids), jnp.asarray(m))
    got = trun(_as_torch(state), torch.from_numpy(ts),
               torch.from_numpy(args), torch.from_numpy(ids),
               torch.from_numpy(m))
    _assert_same(got, want)
    if not m.any():
        _assert_same(got, state)


# Entity ids out of range (ROADMAP C3): JAX's gather clamps, its
# scatter drops, and a negative id wraps once.  The values are JAX's
# for ``s + 1`` over the leaf [0, 1, 2, 3] with both lanes real.
C3_CASES = {
    "i32_max": ([2**31 - 1, 1], [0, 2, 2, 3]),
    "minus_one": ([-1, 1], [0, 2, 2, 4]),
    "minus_five": ([-5, 1], [0, 2, 2, 3]),
    "past_end": ([4, 1], [0, 2, 2, 3]),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(C3_CASES))
def test_out_of_range_ids_match_jax(case, masked):
    ids, table = C3_CASES[case]
    ids = np.asarray(ids, np.int32)
    leaf = np.arange(4, dtype=np.int32)
    ts = np.zeros(2, np.float32)
    args = np.zeros((2, 4), np.float32)
    mask = np.ones(2, bool)
    make_j = jvec.make_masked_run_handler if masked else jvec.make_run_handler
    make_t = tvec.make_masked_run_handler if masked else tvec.make_run_handler
    jrun = make_j(lambda s, t, a: s + 1)
    trun = make_t(lambda s, t, a: s + 1)
    jargs = [jnp.asarray(leaf), jnp.asarray(ts), jnp.asarray(args),
             jnp.asarray(ids)] + ([jnp.asarray(mask)] if masked else [])
    targs = [torch.from_numpy(leaf.copy()), torch.from_numpy(ts),
             torch.from_numpy(args), torch.from_numpy(ids)] + (
        [torch.from_numpy(mask)] if masked else [])
    want = np.asarray(jrun(*jargs))
    got = trun(*targs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == table


@pytest.mark.parametrize("masked", [False, True])
def test_out_of_range_ids_per_leaf_size_match_jax(masked):
    # Leaves of different entity counts wrap, clamp and drop each by
    # its own count: id 4 is past the end of the first leaf only.
    ids = np.asarray([-1, 4], np.int32)
    state = {"a": np.arange(4, dtype=np.int32),
             "b": np.arange(6, dtype=np.int32)}
    ts = np.zeros(2, np.float32)
    args = np.zeros((2, 4), np.float32)
    mask = np.ones(2, bool)
    make_j = jvec.make_masked_run_handler if masked else jvec.make_run_handler
    make_t = tvec.make_masked_run_handler if masked else tvec.make_run_handler
    jrun = make_j(lambda s, t, a: {k: v + 1 for k, v in s.items()})
    trun = make_t(lambda s, t, a: {k: v + 1 for k, v in s.items()})
    jargs = [_as_jax(state), jnp.asarray(ts), jnp.asarray(args),
             jnp.asarray(ids)] + ([jnp.asarray(mask)] if masked else [])
    targs = [_as_torch(state), torch.from_numpy(ts),
             torch.from_numpy(args), torch.from_numpy(ids)] + (
        [torch.from_numpy(mask)] if masked else [])
    want = jrun(*jargs)
    _assert_same(trun(*targs), want)
    assert np.asarray(want["a"]).tolist() == [0, 1, 2, 4]
    assert np.asarray(want["b"]).tolist() == [0, 1, 2, 3, 5, 6]


def test_is_single_type_run():
    for ids in ([2, 2, 2], [0], [], [1, 1, 0], (3, 3)):
        assert tvec.is_single_type_run(ids) == jvec.is_single_type_run(ids)
    assert tvec.is_single_type_run([4, 4])
    assert not tvec.is_single_type_run([])


def _poke_jax(state, t, arg):
    i = arg[0].astype(jnp.int32)
    state = {**state, "hits": state["hits"].at[i].add(1)}
    row = jnp.stack([jnp.float32(1.25), jnp.where(t < 9.0, 0.0, -1.0),
                     ((i + 3) % N).astype(jnp.float32), 0.0, 0.0, 0.0])
    return state, row[None]


def _poke_torch(state, t, arg):
    i = arg[0].to(torch.int64).reshape(1)
    hits = state["hits"].index_add(0, i, torch.ones(1, dtype=torch.int32))
    row = torch.zeros((1, 6))
    row[0, 0] = 1.25
    row[0, 1] = torch.where(t < 9.0, 0.0, -1.0)
    row[0, 2] = ((i[0] + 3) % N).to(torch.float32)
    return {**state, "hits": hits}, row


def _tally(es, t, arg):
    return {**es, "area": es["area"] + es["hits"] * 2 + 1}


def _entity_program(program_cls, config_cls, poke):
    """Cells on a ring: POKE (emitting, whole state) and TALLY
    (entity-local) windows mix; TALLY runs at the grid points."""
    prog = program_cls("cells", config=config_cls(max_batch_len=4,
                                                  capacity=128, max_emit=1))
    prog.register("POKE", poke, lookahead=0.5, emits=True)
    prog.entity_handler("TALLY", lookahead=1.0)(_tally)
    for c in range(3):
        prog.schedule(0.25 * c, "POKE", arg=[float(c)])
    for g in (1.0, 2.5, 4.0, 6.5):
        for c in range(N):
            prog.schedule(g, "TALLY", arg=[float((7 * c) % N)])
    return prog


def test_entity_run_path_matches_sequential_and_jax():
    jprog = _entity_program(JProgram, JConfig, _poke_jax)
    jres = jprog.build(backend="device").run(
        {"hits": jnp.zeros((N,), jnp.int32),
         "area": jnp.zeros((N,), jnp.int32)})
    results = {}
    for route in ("run", "sequential"):
        tprog = _entity_program(TProgram, TConfig, _poke_torch)
        eng = DeviceEngine.from_program(tprog, device="cpu")
        if route == "sequential":
            # The same registry without the entity table: every TALLY
            # goes through the gather-apply-scatter form.
            eng = DeviceEngine(tprog.device_registry(), max_batch_len=4,
                               capacity=128, max_emit=1, device="cpu")
        tq.COUNTS.clear()
        results[route] = CompiledSim(tprog, eng).run(
            {"hits": torch.zeros(N, dtype=torch.int32),
             "area": torch.zeros(N, dtype=torch.int32)})
        results[route + "_runs"] = tq.COUNTS["run_path"]
    assert results["run_runs"] > 0 and results["sequential_runs"] == 0
    for route in ("run", "sequential"):
        assert_run_parity(jres, results[route])
    assert int(results["run"].state["area"].sum()) > 0
