"""The stacked shard layout of ``repro_torch`` against ``repro``'s.

JAX's ``StackedShardedQueue`` (every leaf of the per-shard tiered3 queue
with a leading shard axis, the global counters scalars) and its eight
``tiered3_stacked_*`` helpers, which lift the per-shard ops with
``vmap``; ``stacked_sharded_fault_bits``; the sharded engine's stacked
branches (occupancy, the cheap fault word, the absorb).  The port's
summaries and pop are one batched op over the stack, its peek, fill and
absorb loop over the shards; each is held bit for bit to JAX's helper on
the same queue and to the port's per-shard op mapped over the tuple
layout.  The queues are the near-full churn of
``tests/test_sharded_engine.py`` at 3 shards (fronts of 6, staging of 5,
2 runs), seeded and after 9 and 24 super-steps of the port's serial run
(which ``tests/test_torch_sharded.py`` holds to JAX's), carried across
packages field by field.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.sharded as jsharded
import test_sharded_engine as jshard
from repro.core import queue as JQ
from repro.core import validate as JV
from repro.core.queue import Tiered3DeviceQueue as JTiered3
from repro.core.queue import tiered3_queue_to_flat as j_to_flat
from repro_torch.core import queue as tq
from repro_torch.core import sharded as tsharded
from repro_torch.core import validate as V
from repro_torch.core.queue import COUNTS
from repro_torch.core.sharded import (
    ShardedQueue,
    StackedShardedQueue,
    place_stacked_queue,
    stack_sharded_queue,
)
from _torch_churn import EMIT_W, assert_flat_equal, engine, state0

SHARDS = 3
K = 4


def _port_sharded(batches: int) -> ShardedQueue:
    eng = engine(SHARDS)
    sq = eng.initial_queue(jshard._seed_events(4, 48, 12))
    if batches:
        _, sq, _ = eng.run(state0(), sq, max_batches=batches)
    return sq


def _to_jax(sq: ShardedQueue):
    """The same sharded queue in JAX's types, then stacked by JAX."""
    shards = tuple(
        JTiered3(**{k: jnp.asarray(v)
                    for k, v in tq.queue_to_arrays(q).items()})
        for q in sq.shards)
    jsq = jsharded.ShardedQueue(
        shards=shards, size=jnp.int32(int(sq.size)),
        next_seq=jnp.int32(int(sq.next_seq)),
        dropped=jnp.int32(int(sq.dropped)))
    return jsq, jsharded.stack_sharded_queue(jsq)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _stacked_equal(tq_stacked, jq_stacked, msg=""):
    """Every field of the two stacked queues, bit for bit."""
    for name in tq_stacked._fields:
        _eq(getattr(tq_stacked, name).numpy(),
            np.asarray(getattr(jq_stacked, name)), f"{msg}: {name}")


def _tuple_equal(tq_stacked, shards, msg=""):
    """The port's stacked result against its per-shard results."""
    for i, q in enumerate(shards):
        for name in q._fields:
            _eq(getattr(tq_stacked, name)[i].numpy(),
                getattr(q, name).numpy(), f"{msg}: shard {i} {name}")


@pytest.fixture(scope="module", params=[0, 9, 24], ids=lambda b: f"b{b}")
def queues(request):
    sq = _port_sharded(request.param)
    jsq, jstq = _to_jax(sq)
    return sq, stack_sharded_queue(sq), jsq, jstq


def test_stacked_layout_matches_jax(queues):
    sq, stq, _, jstq = queues
    assert stq.num_shards == jstq.num_shards == SHARDS
    assert stq.capacity == jstq.capacity == sq.capacity == 48
    _stacked_equal(stq.q, jstq.q, "stack")
    for name in ("size", "next_seq", "dropped"):
        assert int(getattr(stq, name)) == int(getattr(jstq, name))
    _tuple_equal(stq.q, sq.shards, "shard views")
    for i in range(SHARDS):
        assert_flat_equal(tq.tiered3_queue_to_flat(stq.shard(i)),
                          j_to_flat(jstq.shard(i)), f"shard {i}")
    assert_flat_equal(tsharded.sharded_queue_to_flat(stq),
                      jsharded.sharded_queue_to_flat(jstq), "flat")


def test_stacked_summaries_match_jax_and_tuple(queues):
    sq, stq, _, jstq = queues
    syncs = COUNTS["host_syncs"]
    cases = [
        (tq.tiered3_stacked_has_pending, JQ.tiered3_stacked_has_pending,
         tq.tiered3_queue_has_pending),
        (tq.tiered3_stacked_occupancy, JQ.tiered3_stacked_occupancy,
         tq.tiered3_queue_occupancy),
        (tq.tiered3_stacked_next_time, JQ.tiered3_stacked_next_time,
         tq.tiered3_queue_next_time),
    ]
    for port, jax_fn, single in cases:
        got = port(stq.q)
        assert got.shape == (SHARDS,), port.__name__
        _eq(got.numpy(), jax_fn(jstq.q), port.__name__)
        _eq(got.numpy(), torch.stack([single(q) for q in sq.shards]),
            port.__name__)
    kt, ks = tq.tiered3_stacked_next_key(stq.q)
    jkt, jks = JQ.tiered3_stacked_next_key(jstq.q)
    _eq(kt.numpy(), jkt)
    _eq(ks.numpy(), jks)
    for i, q in enumerate(sq.shards):
        t_i, s_i = tq.tiered3_queue_next_key(q)
        assert (float(kt[i]), int(ks[i])) == (float(t_i), int(s_i)), i
    # Pure device work: no host read.
    assert COUNTS["host_syncs"] == syncs


_JITTED = {}


def _jit(fn, **kw):
    """JAX's helper jitted once a module (eager vmap of its conds takes
    seconds an op)."""
    if fn not in _JITTED:
        _JITTED[fn] = jax.jit(fn, **kw)
    return _JITTED[fn]


def test_stacked_peek_pop_fill_match_jax_and_tuple(queues):
    sq, stq, _, jstq = queues
    q2, ts, tys, args, seqs = tq.tiered3_stacked_peek_front(stq.q, K)
    jq2, jts, jtys, jargs, jseqs = _jit(JQ.tiered3_stacked_peek_front,
                                       static_argnums=1)(jstq.q, K)
    _stacked_equal(q2, jq2, "peek")
    for got, want in ((ts, jts), (tys, jtys), (args, jargs),
                      (seqs, jseqs)):
        _eq(got.numpy(), want, "peeked")
    singles = [tq.tiered3_queue_peek_front(q, K) for q in sq.shards]
    _tuple_equal(q2, [s[0] for s in singles], "peek")

    lengths = np.asarray([min(int(n), 2) for n in
                          np.sum(tys.numpy() >= 0, axis=1)], np.int32)
    lengths[-1] = 0     # a shard that pops nothing
    q3 = tq.tiered3_stacked_pop_prefix(q2, torch.from_numpy(lengths), K)
    jq3 = _jit(JQ.tiered3_stacked_pop_prefix, static_argnums=2)(
        jq2, lengths, K)
    _stacked_equal(q3, jq3, "pop")
    popped = [tq.tiered3_queue_pop_prefix(
        s[0], torch.tensor(int(n), dtype=torch.int32), K)
              for s, n in zip(singles, lengths)]
    _tuple_equal(q3, popped, "pop")

    # Four rows, one a skipped type -1, one routed to two shards: the
    # staging ring of 5 flushes to a run on the fuller shards.
    rows = np.zeros((4, EMIT_W), np.float32)
    rows[:, 0] = [3.25, 7.5, 0.75, 1e5]
    rows[:, 1] = [0.0, 0.0, -1.0, 0.0]
    rows[:, 2] = [1.0, 2.0, 3.0, 4.0]
    seq_r = np.arange(500, 504, dtype=np.int32)
    ins = np.zeros((SHARDS, 4), bool)
    ins[0, 0] = ins[1, 1] = ins[2, 2] = ins[0, 3] = ins[2, 3] = True
    q4 = tq.tiered3_stacked_fill_rows_tagged(
        q3, torch.from_numpy(rows), torch.from_numpy(seq_r),
        torch.from_numpy(ins))
    jq4 = _jit(JQ.tiered3_stacked_fill_rows_tagged)(
        jq3, jnp.asarray(rows), jnp.asarray(seq_r), jnp.asarray(ins))
    _stacked_equal(q4, jq4, "fill")
    filled = [tq.tiered3_queue_fill_rows_tagged(
        q, torch.from_numpy(rows), torch.from_numpy(seq_r),
        torch.from_numpy(ins[i])) for i, q in enumerate(popped)]
    _tuple_equal(q4, filled, "fill")

    # Arrivals with seqs older than queued ones, absorbed under the lex
    # key: eight rows, two stage_cap chunks a shard.
    rows_a = np.zeros((8, EMIT_W), np.float32)
    rows_a[:, 0] = [0.5, 2.0, 2.0, 9.5, 40.0, 0.5, 100.0, 3.25]
    rows_a[:, 2] = np.arange(8)
    seq_a = np.asarray([3, 1, 2, 7, 11, 13, 17, 19], np.int32)
    ins_a = np.zeros((SHARDS, 8), bool)
    ins_a[np.arange(8) % SHARDS, np.arange(8)] = True
    q5 = tq.tiered3_stacked_absorb_rows(
        q4, torch.from_numpy(rows_a), torch.from_numpy(seq_a),
        torch.from_numpy(ins_a))
    jq5 = _jit(JQ.tiered3_stacked_absorb_rows)(
        jq4, jnp.asarray(rows_a), jnp.asarray(seq_a), jnp.asarray(ins_a))
    _stacked_equal(q5, jq5, "absorb")
    absorbed = [tq.tiered3_queue_absorb_rows(
        q, torch.from_numpy(rows_a), torch.from_numpy(seq_a),
        insert=torch.from_numpy(ins_a[i])) for i, q in enumerate(filled)]
    _tuple_equal(q5, absorbed, "absorb")


def test_stacked_fault_bits_match_jax(queues):
    sq, stq, _, jstq = queues
    got = V.stacked_sharded_fault_bits(stq)
    assert int(got) == int(JV.stacked_sharded_fault_bits(jstq)) == 0
    assert int(got) == int(V.sharded_fault_bits(sq))
    # A shard whose front counter lies: the same bits in all three.
    bad = stq._replace(q=stq.q._replace(
        front_n=stq.q.front_n + torch.tensor([0, 1, 0], dtype=torch.int32)))
    jbad = jstq._replace(q=jstq.q._replace(
        front_n=jstq.q.front_n + jnp.asarray([0, 1, 0], jnp.int32)))
    word = int(V.stacked_sharded_fault_bits(bad))
    assert word != 0
    assert word == int(JV.stacked_sharded_fault_bits(jbad))
    assert word == int(V.sharded_fault_bits(
        ShardedQueue(shards=bad.shards, size=bad.size,
                     next_seq=bad.next_seq, dropped=bad.dropped)))


def test_engine_stacked_branches_match_jax_and_tuple(queues):
    sq, stq, jsq, jstq = queues
    eng = engine(SHARDS, validate="cheap")
    jeng = jshard._engine(SHARDS)
    occ = eng.queue_occupancy(stq)
    assert int(occ) == int(eng.queue_occupancy(sq))
    assert int(occ) == int(jeng.queue_occupancy(jstq))
    assert int(eng._cheap_fault_bits(stq)) == int(
        eng._cheap_fault_bits(sq)) == 0

    rows = np.zeros((6, EMIT_W), np.float32)
    rows[:, 0] = [1.5, 0.5, 6.0, 2.5, 1e5, 4.0]
    rows[:, 1] = [0.0, 0.0, 0.0, -1.0, 0.0, 0.0]
    rows[:, 2] = [0.0, 4.0, 7.0, 1.0, 11.0, 5.0]
    seqs = np.asarray([2, 5, 8, 9, 10, 44], np.int32)
    insert = np.asarray([True, True, True, True, False, True])
    got = eng.absorb_rows(stq, torch.from_numpy(rows),
                          torch.from_numpy(seqs), torch.from_numpy(insert))
    assert isinstance(got, StackedShardedQueue)
    want = eng.absorb_rows(sq, torch.from_numpy(rows),
                           torch.from_numpy(seqs), torch.from_numpy(insert))
    jgot = _jit(jeng.absorb_rows)(jstq, jnp.asarray(rows),
                                  jnp.asarray(seqs), jnp.asarray(insert))
    _stacked_equal(got.q, jgot.q, "engine absorb")
    _tuple_equal(got.q, want.shards, "engine absorb")
    for name in ("size", "next_seq", "dropped"):
        assert (int(getattr(got, name)) == int(getattr(want, name))
                == int(getattr(jgot, name))), name
    assert int(eng._cheap_fault_bits(got)) == 0


def test_sharded_exports_match_jax():
    assert tsharded.__all__ == jsharded.__all__


def test_stacked_placement_and_run_name_d1():
    """A stacked queue runs under ``placement="devices"`` only (ROADMAP
    D1): the serial engine refuses it and still runs the tuple layout of
    the same pending set; ``place_stacked_queue`` needs a ``"shards"``
    mesh of as many ranks as the queue has shards, and a one-rank gloo
    group has too few for 3 shards (``tests/test_torch_devices.py``
    places and runs the layout on four ranks)."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_shard_mesh

    sq = _port_sharded(0)
    stq = stack_sharded_queue(sq)
    eng = engine(SHARDS)
    with pytest.raises(ValueError, match="placement='devices'"):
        eng.run(state0(), stq, max_batches=4)
    _, _, stats = eng.run(state0(), sq, max_batches=4)
    assert stats["batches"] == 4
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="has 1 rank"):
            make_shard_mesh(SHARDS, device="cpu")
        with pytest.raises(ValueError, match="3 shards on a mesh of 1"):
            place_stacked_queue(stq, make_shard_mesh(1, device="cpu"))
    finally:
        dist.destroy_process_group()
