"""The host backend of ``repro_torch`` against ``repro``'s, entry by entry.

The five host entries of ``tests/_parity.py`` (``host/conservative``,
``host/speculative``, ``host/unbatched`` and the two ``+stream``
entries) build from one program definition in each package and run the
same scenarios: PHOLD (5 LPs), the M/M/c network (3 stations), the PoC
model (64 iterations, windows of 3, both codecs and the eager
composer) and the closed and open admission scenarios.  The port runs
with ``device="cpu", jit_handlers=False`` (the eager route; the
compile route is ``torch.compile`` of the same words and runs on the
card in ``chip_smoke.py``).  Held exactly: every state leaf, events,
batches, final_time, rollbacks and ingested against JAX's same entry,
and ``host/conservative``'s batches against the port's device runs.
"""

import sys

import numpy as np
import pytest

import jax

import _parity
from repro import poc as jpoc
from repro.core.program import Config as JConfig
from repro.serving import scenarios as jsc
from repro.stream import PoissonSource as JPoisson
from repro_torch import poc as tpoc
from repro_torch.api import Config as TConfig
from repro_torch.api import PoissonSource as TPoisson
from repro_torch.examples import mmc_network as tmmc
from repro_torch.examples import phold as tphold
from repro_torch.serving import scenarios as tsc

from test_torch_engine import ROOT, tree_leaves

sys.path.insert(0, str(ROOT / "examples"))
import mmc_network as jmmc  # noqa: E402  (examples/ is not a package)
import phold as jphold  # noqa: E402

HOST = {k: v for k, v in _parity.ALL_BACKENDS.items()
        if k.startswith("host/")}
HOST_STREAM = {k: v for k, v in _parity.STREAM_BACKENDS.items()
               if k.startswith("host/")}
TORCH_KW = dict(device="cpu", jit_handlers=False)


def assert_states_equal(jstate, tstate, msg=""):
    jleaves = jax.tree_util.tree_leaves(jstate)
    tleaves = tree_leaves(tstate)
    assert len(jleaves) == len(tleaves), msg
    for jl, tl in zip(jleaves, tleaves):
        want = np.asarray(jl)
        got = tl.numpy()
        if want.dtype == np.uint32:      # u32 leaves live in int64
            want = want.astype(np.int64)
        assert got.dtype == want.dtype, msg
        np.testing.assert_array_equal(got, want, err_msg=msg)


def assert_host_parity(jres, tres, label):
    assert_states_equal(jres.state, tres.state, label)
    assert tres.events == jres.events, label
    assert tres.batches == jres.batches, label
    assert tres.dropped == jres.dropped == 0, label
    assert tres.final_time == jres.final_time, label
    assert tres.rollbacks == jres.rollbacks, label
    assert tres.ingested == jres.ingested, label
    assert tres.stats() == jres.stats(), label


def run_host_matrix(jbuild, tbuild, jstate, tstate, entries=HOST,
                    run_kw=None, trun_kw=None, jax_eager=False):
    """Both packages' runs of every entry; ``{label: (jres, tres)}``.
    ``jax_eager`` runs JAX's side op by op (``jax.disable_jit``): its
    composers compile every word otherwise, seconds a word on one core,
    and these models' integer and grid-exact arithmetic gives the same
    bits either way (the JAX parity suite holds its host runs, one jit
    a word, to its device runs, one jit a run)."""
    out = {}
    for label, kw in entries.items():
        with jax.disable_jit(jax_eager):
            jres = jbuild().build(**kw).run(jstate(), **(run_kw or {}))
        tres = tbuild().build(**kw, **TORCH_KW).run(
            tstate(), **(trun_kw or run_kw or {}))
        assert_host_parity(jres, tres, label)
        out[label] = (jres, tres)
    return out


def assert_batched_like_device(runs, tbuild, tstate, run_kw=None):
    """``host/conservative`` groups its batches as the device engine
    does (the §III-B window), and every host entry ends in the device
    run's state."""
    dev = tbuild().build(backend="device", device="cpu").run(
        tstate(), **(run_kw or {}))
    assert runs["host/conservative"][1].batches == dev.batches
    for label, (_jres, tres) in runs.items():
        for a, b in zip(tree_leaves(tres.state), tree_leaves(dev.state)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=label)
        assert tres.events == dev.events, label
        assert np.float32(tres.final_time) == np.float32(dev.final_time)


def test_phold_host_entries_match_jax():
    runs = run_host_matrix(
        lambda: jphold.build_program(num_lps=5, t_stop=12.0),
        lambda: tphold.build_program(num_lps=5, t_stop=12.0),
        lambda: jphold.initial_state(5), lambda: tphold.initial_state(5))
    assert_batched_like_device(
        runs, lambda: tphold.build_program(num_lps=5, t_stop=12.0),
        lambda: tphold.initial_state(5))
    assert runs["host/unbatched"][1].events > 20
    assert runs["host/speculative"][1].rollbacks > 0


def test_mmc_host_entries_match_jax():
    runs = run_host_matrix(
        lambda: jmmc.build_program(num_stations=3, t_open=12.0),
        lambda: tmmc.build_program(num_stations=3, t_open=12.0),
        lambda: jmmc.initial_state(3), lambda: tmmc.initial_state(3),
        jax_eager=True)
    assert_batched_like_device(
        runs, lambda: tmmc.build_program(num_stations=3, t_open=12.0),
        lambda: tmmc.initial_state(3))
    st = runs["host/conservative"][1].state
    assert int(st["samples"].sum()) > 0
    np.testing.assert_array_equal(
        st["arrived"].numpy(),
        (st["served"] + st["qlen"] + st["busy"]).numpy())


POC_TYPES = [0, 1, 0, 0, 1, 1, 0, 0, 1]


def _poc(pkg, cfg_cls, codec):
    def build():
        prog = pkg.build_program(iters=64, config=cfg_cls(max_batch_len=3,
                                                          codec=codec))
        for t, ty in enumerate(POC_TYPES):
            prog.schedule(float(t), ("Increment", "Set")[ty])
        return prog
    return build


@pytest.mark.parametrize("codec", ["dense", "paper"])
def test_poc_host_entries_match_jax(codec):
    import jax.numpy as jnp
    import torch

    jbuild, tbuild = _poc(jpoc, JConfig, codec), _poc(tpoc, TConfig, codec)
    runs = run_host_matrix(jbuild, tbuild, jpoc.initial_state,
                           tpoc.initial_state)
    oracle = tpoc.reference_final_sum(POC_TYPES, 64)
    assert int(runs["host/conservative"][1].state) == oracle
    if codec == "dense":
        assert_batched_like_device(runs, tbuild, tpoc.initial_state)
    jres = jbuild().build(backend="host", composer="eager",
                          state_spec=jnp.zeros((), jnp.uint32)).run(
        jpoc.initial_state())
    tres = tbuild().build(backend="host", composer="eager",
                          state_spec=((), torch.int64), **TORCH_KW).run(
        tpoc.initial_state())
    assert_host_parity(jres, tres, "eager composer")


def _admission(pkg, cfg_cls):
    return lambda: pkg.build_admission_program(
        num_slots=4, num_requests=24, max_decode=5,
        config=cfg_cls(max_batch_len=3, capacity=256, max_emit=2))


def test_closed_admission_host_entries_match_jax():
    tbuild = _admission(tsc, TConfig)
    runs = run_host_matrix(_admission(jsc, JConfig), tbuild,
                           lambda: jsc.initial_state(4),
                           lambda: tsc.initial_state(4), jax_eager=True)
    assert_batched_like_device(runs, tbuild, lambda: tsc.initial_state(4))
    st = runs["host/speculative"][1].state
    assert int(st["served"]) == 24 and int(st["retries"]) > 0


def _open(pkg, cfg_cls):
    return lambda: pkg.build_open_admission_program(
        num_slots=4, num_requests=40, max_decode=5,
        config=cfg_cls(max_batch_len=3, capacity=256, max_emit=2))


def _source(cls):
    return cls(1.5, 40, seed=42, grid=0.25, t0=0.0, type_id=0,
               block_size=16)


def test_streamed_host_entries_match_jax_and_preseeded():
    """Both ``host/*+stream`` entries against JAX's streamed runs, and
    against the port's device stream and the closed pre-seeded run."""
    from repro_torch.stream import source_events

    runs = run_host_matrix(
        _open(jsc, JConfig), _open(tsc, TConfig),
        lambda: jsc.initial_state(4), lambda: tsc.initial_state(4),
        entries=HOST_STREAM, run_kw=dict(arrivals=_source(JPoisson)),
        trun_kw=dict(arrivals=_source(TPoisson)), jax_eager=True)
    closed = [(1.0, "TICK")] + [(t, ty, list(arg)) for (t, ty, arg)
                                in source_events(_source(TPoisson))]
    pre = _open(tsc, TConfig)().build(
        backend="host", scheduler="unbatched", **TORCH_KW).run(
        tsc.initial_state(4), events=closed)
    dev = _open(tsc, TConfig)().build(backend="device", device="cpu").run(
        tsc.initial_state(4), arrivals=_source(TPoisson))
    for label, (_j, tres) in runs.items():
        assert tres.ingested == 40, label
        for ref in (pre, dev):
            for a, b in zip(tree_leaves(tres.state), tree_leaves(ref.state)):
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=label)
            assert tres.events == ref.events, label
            assert tres.final_time == ref.final_time, label


def test_until_horizon_and_rerun_match_jax():
    """``until`` caps the window on every host entry (the speculative
    slack never crosses it), and one handle re-runs identically."""
    runs = run_host_matrix(
        lambda: jphold.build_program(num_lps=4, t_stop=20.0),
        lambda: tphold.build_program(num_lps=4, t_stop=20.0),
        lambda: jphold.initial_state(4), lambda: tphold.initial_state(4),
        run_kw=dict(until=7.5))
    dev = tphold.build_program(num_lps=4, t_stop=20.0).build(
        backend="device", device="cpu").run(tphold.initial_state(4),
                                            until=7.5)
    for label, (_j, tres) in runs.items():
        assert tres.final_time <= 7.5, label
        assert tres.events == dev.events, label
        assert int(tres.state["checksum"]) == int(dev.state["checksum"])
    sim = tphold.build_program(num_lps=4, t_stop=6.0).build(
        backend="host", scheduler="speculative", **TORCH_KW)
    r1 = sim.run(tphold.initial_state(4))
    r2 = sim.run(tphold.initial_state(4))
    assert r1.stats() == r2.stats()
    assert int(r1.state["checksum"]) == int(r2.state["checksum"])
