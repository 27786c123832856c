"""The cross-shard churn of ``tests/test_sharded_engine.py`` in the port,
shared by the port's sharded tests; it imports no JAX, so the ranks of
``tests/test_torch_devices.py`` load it without JAX."""

import numpy as np
import torch

from repro_torch.core import queue as tq
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.events import ARG_WIDTH, EventRegistry, emits_events
from repro_torch.core.sharded import (
    ShardedDeviceEngine,
    ShardedQueue,
    StackedShardedQueue,
    sharded_queue_to_flat,
)

EMIT_W = 2 + ARG_WIDTH
M32 = 0xFFFFFFFF


def _mix(t, src):
    """``test_sharded_engine._mix`` in int64 with a u32 mask."""
    t2 = (t * 2.0).to(torch.int64)
    h = (t2 * 2654435761 + src.to(torch.int64) * 40503 + 12345) & M32
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & M32
    return h ^ (h >> 15)


def churn_registry(num_entities: int, t_stop: float):
    """The JAX suite's order-sensitive churn: each event folds its hash
    into a checksum and re-emits one row, near-head or far-future by the
    hash, to a hash-chosen entity."""
    reg = EventRegistry()

    @emits_events
    def churn(state, t, arg):
        src = arg[0].to(torch.int32)
        h = _mix(t, src)
        near = (h % 3) != 0
        delay = torch.where(near, 0.5 + 0.5 * ((h >> 3) % 4).float(),
                            1e5 + ((h >> 3) % 8).float())
        dst = (h >> 7) % num_entities
        emit = torch.zeros((1, EMIT_W), dtype=torch.float32)
        emit[0, 0] = t + delay
        emit[0, 1] = torch.where(t < t_stop, 0.0, -1.0)
        emit[0, 2] = dst.float()
        return {"count": state["count"] + 1,
                "checksum": (state["checksum"] * 31 + h) & M32}, emit

    reg.register("CHURN", churn, lookahead=0.5)
    return reg.freeze()


def state0():
    return {"count": torch.tensor(0, dtype=torch.int32),
            "checksum": torch.tensor(1, dtype=torch.int64)}


def engine(shards, *, capacity=48, max_len=4, num_entities=12,
           t_stop=64.0, front_cap=6, stage_cap=5, num_runs=2,
           validate="off", **kw):
    """The JAX suite's geometry; ``shards=0`` is the single queue."""
    reg = churn_registry(num_entities, t_stop)
    common = dict(max_batch_len=max_len, capacity=capacity, max_emit=1,
                  front_cap=front_cap, stage_cap=stage_cap,
                  num_runs=num_runs, validate=validate, device="cpu", **kw)
    if shards == 0:
        return DeviceEngine(reg, queue_mode="tiered3", **common)
    return ShardedDeviceEngine(reg, shards=shards, **common)


def flat_of(q):
    return (sharded_queue_to_flat(q)
            if isinstance(q, (ShardedQueue, StackedShardedQueue))
            else tq.tiered3_queue_to_flat(q))


def assert_flat_equal(fa, fb, msg=""):
    for field in ("times", "types", "args", "seqs"):
        np.testing.assert_array_equal(np.asarray(getattr(fa, field)),
                                      np.asarray(getattr(fb, field)),
                                      err_msg=f"{msg}: {field}")
    for field in ("size", "next_seq", "dropped"):
        assert int(getattr(fa, field)) == int(getattr(fb, field)), \
            (msg, field)


def assert_stats_equal(sa, sb, msg=""):
    for k in ("batches", "events", "dropped", "emitted"):
        assert int(sa[k]) == int(sb[k]), (msg, k)
    assert float(sa["time"]) == float(sb["time"]), msg
    np.testing.assert_array_equal(np.asarray(sa["word_counts"]),
                                  np.asarray(sb["word_counts"]), msg)


def run_engine(eng, events, max_batches=48):
    s, q, st = eng.run(state0(), eng.initial_queue(events),
                       max_batches=max_batches)
    return s, q, st


def seed_events(seed, capacity, num_entities, occupancy=0.92):
    """``test_sharded_engine._seed_events``: ~92% of capacity seed events
    on the 0.5 grid, entities drawn so that every shard starts loaded."""
    rng = np.random.default_rng(seed)
    n = int(capacity * occupancy)
    events = []
    for _ in range(n):
        t = 0.5 * int(rng.integers(0, 2 * n))
        e = int(rng.integers(0, num_entities))
        events.append((t, 0, np.asarray([e, 0, 0, 0], np.float32)))
    return events
