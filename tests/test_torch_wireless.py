"""The paper's §IV.A wireless example on ``repro_torch`` against
``examples/wireless_des.py``.

The message (an LCG of ``MSG_WORK = 100,000`` steps, composed as affine
maps in 17 levels in the port, a ``fori_loop`` in JAX) bit for bit
against JAX's jitted Broadcast handler; the port's host run
(``conservative``, eager words) and its device runs in the two-tier
queue at capacity 4096 and the flat queue at 64, each against JAX's
``conservative`` host run: equal inbox, batches, events and dropped.
JAX's host run is jitted, as its composers always are (under
``jax.disable_jit()`` its 100k-step loop would run in Python).  The
cross-event check's plumbing runs with a recording stand-in for
``torch.compile``: no Inductor compile runs in these tests, so it
reports no generated code; what Inductor does with the dead word is
read on the card (``chip_smoke.py`` phase ``wireless``).  Tolerance:
exact.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.examples import wireless_des as tw
from test_torch_engine import ROOT

sys.path.insert(0, str(ROOT / "examples"))
import wireless_des as jw  # noqa: E402  (examples/ is not a package)


def test_constants_schedule_and_config_match_jax():
    assert (tw.N_RECEIVERS, tw.MSG_WORK) == (jw.N_RECEIVERS, jw.MSG_WORK)
    assert (tw.SLEEP, tw.WAKE, tw.BCAST) == (jw.SLEEP, jw.WAKE, jw.BCAST)
    tp, jp = tw.build_program(), jw.build_program()
    assert [s.name for s in tp._specs] == [s.name for s in jp._specs]
    for field in ("max_batch_len", "capacity", "max_emit"):
        assert getattr(tp.config, field) == getattr(jp.config, field)
    te, je = tp.scheduled_events(), jp.scheduled_events()
    assert [(t, ty) for t, ty, _ in te] == [(t, ty) for t, ty, _ in je]


def test_message_bit_equal_to_jax_loop():
    """At MSG_WORK = 100,000 itself: JAX's Broadcast on a zero inbox
    with every receiver awake delivers exactly the message."""
    assert tw.MSG_WORK == 100_000
    msg = tw.message("cpu")
    assert msg.dtype == torch.int64 and msg.shape == (1,)
    reg = jw.build_program().host_registry()
    out = jax.jit(lambda s: reg[jw.BCAST].handler(s, jnp.float32(1.0),
                                                  None))(jw.initial_state())
    want = np.asarray(out["inbox"])
    assert want.dtype == np.uint32
    assert np.all(want == int(msg[0])), (want, int(msg[0]))
    # and the sequential recurrence, step by step
    m = tw.LCG_SEED
    for _ in range(tw.MSG_WORK):
        m = (m * tw.LCG_A + tw.LCG_C) & 0xFFFFFFFF
    assert int(msg[0]) == m


def test_message_wraps_every_product_mod_2_32():
    """``_mul32`` against Python's exact products at the u32 edges."""
    vals = [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000000, tw.LCG_A,
            tw.LCG_C, 2654435761]
    a = torch.tensor([x for x in vals for _ in vals], dtype=torch.int64)
    b = torch.tensor([y for _ in vals for y in vals], dtype=torch.int64)
    got = tw._mul32(a, b).tolist()
    assert got == [(x * y) & 0xFFFFFFFF for x in vals for y in vals]


@pytest.fixture(scope="module")
def jax_host_run():
    return jw.build_program().build(
        backend="host", scheduler="conservative").run(jw.initial_state())


@pytest.fixture(scope="module")
def port_runs():
    return tw.run_all("cpu", jit_handlers=False)


@pytest.mark.parametrize("backend", ["host", "tiered", "flat"])
def test_backends_match_jax_host_run(jax_host_run, port_runs, backend):
    res = port_runs[backend]
    want = np.asarray(jax_host_run.state["inbox"]).astype(np.int64)
    assert res.state["inbox"].tolist() == want.tolist()
    assert res.state["awake"].tolist() == np.asarray(
        jax_host_run.state["awake"]).astype(np.int64).tolist()
    for field in ("batches", "events", "dropped"):
        assert int(getattr(res, field)) == int(getattr(jax_host_run,
                                                       field)), field
    assert res.events == 40 and res.dropped == 0


def test_cross_event_check_composes_and_compiles_both_words(monkeypatch):
    """The check's plumbing with ``torch.compile`` recorded, not run:
    each word is handed to it whole with ``fullgraph=True``; the dead
    word delivers nothing and the live one the message."""
    seen = []

    def fake(fn, **kw):
        seen.append((fn.__name__, kw))
        return fn

    monkeypatch.setattr(torch, "compile", fake)
    out = tw.cross_event_check("cpu", reps=2)
    assert seen == [("batch_SleepAll_Broadcast_WakeAll", {"fullgraph": True}),
                    ("batch_WakeAll_Broadcast_SleepAll", {"fullgraph": True})]
    msg = int(tw.message("cpu")[0])
    assert out["dead_inbox"] == [0] * tw.N_RECEIVERS
    assert out["live_inbox"] == [msg] * tw.N_RECEIVERS
    # Uncompiled, no generated code exists to hold the work.
    assert not out["dead_work_in_code"] and not out["live_work_in_code"]
    assert out["dead_ms"] > 0 and out["live_ms"] > 0
