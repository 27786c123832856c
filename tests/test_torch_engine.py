"""End-to-end runs of ``repro_torch`` against ``repro``'s device backend.

The same PoC and PHOLD programs, with the same seeded inputs, run
through the JAX device backend (tiered3 queue) and through
``repro_torch`` on the CPU, under ``switch``, ``masked`` and ``fused``
dispatch (fused with its default hot set and with hot words profiled
from a ``switch`` run's histogram).
Held with the ``tests/_parity.py`` assertion set — final state (every
leaf), events, batches, dropped, final_time — plus the per-word batch
histogram and every field of the final queue.  Tolerance: exact.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import poc as jpoc
from repro.core.program import Config as JConfig
from repro_torch.api import Config as TConfig
from repro_torch.api import state_from_numpy
from repro_torch.core import queue as tq
from repro_torch.examples import phold as tphold
from repro_torch.examples import poc as tpoc

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
import phold as jphold  # noqa: E402  (examples/ is not a package)

MODES = ("switch", "masked", "fused")


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util.tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def assert_run_parity(jres, tres):
    jleaves = jax.tree_util.tree_leaves(jres.state)
    tleaves = tree_leaves(tres.state)
    assert len(jleaves) == len(tleaves)
    for jl, tl in zip(jleaves, tleaves):
        want = np.asarray(jl)
        got = tl.numpy()
        if want.dtype == np.uint32:      # u32 leaves live in int64
            assert got.dtype == np.int64
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got, want)
    assert tres.events == jres.events
    assert tres.batches == jres.batches
    assert tres.dropped == jres.dropped
    assert np.float32(tres.final_time) == np.float32(jres.final_time)
    assert tres.emitted == jres.emitted
    assert tres.pending == jres.pending
    np.testing.assert_array_equal(tres.word_counts,
                                  np.asarray(jres.word_counts))
    jq = jres.raw["final_queue"]
    got = tq.tiered3_queue_to_arrays(tres.raw["final_queue"])
    for name in jq._fields:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jq, name)),
                                      err_msg=f"final queue field {name}")


@pytest.mark.parametrize("mode", MODES)
def test_poc_matches_jax(mode):
    iters = 16
    evs = jpoc.schedule_poc_events(256, 0.3, seed=7)
    assert evs == tpoc.schedule_poc_events(256, 0.3, seed=7)
    jp = jpoc.build_program(iters=iters, config=JConfig(max_batch_len=4))
    jres = jp.build(backend="device", dispatch_mode=mode).run(
        jpoc.initial_state(), events=evs)
    tp = tpoc.build_program(iters=iters, config=TConfig(max_batch_len=4))
    tres = tp.build(backend="device", device="cpu",
                    dispatch_mode=mode).run(tpoc.initial_state(), events=evs)
    assert_run_parity(jres, tres)
    types = [ty for _, ty in evs]
    assert int(tres.state) == tpoc.reference_final_sum(types, iters) == \
        jpoc.reference_final_sum(types, iters)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("num_lps,capacity,t_stop,tiers", [
    (8, 256, 40.0, {}),
    (64, 1024, 60.0, dict(front_cap=16, stage_cap=8, num_runs=2)),
    (16, 64, 30.0, dict(front_cap=8, stage_cap=8, num_runs=2)),
])
def test_phold_matches_jax(mode, num_lps, capacity, t_stop, tiers):
    jp = jphold.build_program(num_lps=num_lps, t_stop=t_stop,
                              capacity=capacity)
    jres = jp.build(backend="device", dispatch_mode=mode, **tiers).run(
        jphold.initial_state(num_lps))
    tp = tphold.build_program(num_lps=num_lps, t_stop=t_stop,
                              capacity=capacity)
    tres = tp.build(backend="device", device="cpu", dispatch_mode=mode,
                    **tiers).run(tphold.initial_state(num_lps))
    assert_run_parity(jres, tres)
    assert jres.events > num_lps


def _poc_case():
    evs = jpoc.schedule_poc_events(200, 0.3, seed=11)
    return (jpoc.build_program(iters=16, config=JConfig(max_batch_len=4)),
            tpoc.build_program(iters=16, config=TConfig(max_batch_len=4)),
            jpoc.initial_state(), tpoc.initial_state(), dict(events=evs), 2)


def _phold_case():
    return (jphold.build_program(num_lps=24, t_stop=40.0, capacity=256),
            tphold.build_program(num_lps=24, t_stop=40.0, capacity=256),
            jphold.initial_state(24), tphold.initial_state(24), {}, 1)


@pytest.mark.parametrize("case", [_poc_case, _phold_case])
def test_fused_profiled_hot_words_match_jax(case):
    """Fused dispatch with the top-W words of a switch run's histogram
    (``hot_words_from_counts``), so hot windows and fallback windows
    both run, on PoC and PHOLD."""
    from repro_torch.core.composer import hot_words_from_counts

    jp, tp, jstate, tstate, run_kw, top_w = case()
    profiler = tp.build(backend="device", device="cpu")
    profile = profiler.run(tstate, **run_kw)
    hot = hot_words_from_counts(profile.word_counts, profiler.engine.codec,
                                top_w)
    jres = jp.build(backend="device", dispatch_mode="fused",
                    hot_words=hot).run(jstate, **run_kw)
    tq.COUNTS.clear()
    tres = tp.build(backend="device", device="cpu", dispatch_mode="fused",
                    hot_words=hot).run(tstate, **run_kw)
    assert_run_parity(jres, tres)
    np.testing.assert_array_equal(tres.word_counts, profile.word_counts)
    assert tq.COUNTS["fused_hot"] > 0
    assert tq.COUNTS["fused_fallback"] > 0
    assert tq.COUNTS["fused_hot"] + tq.COUNTS["fused_fallback"] == \
        tres.batches


def test_phold_horizon_and_batch_cap_match_jax():
    """``until`` and ``max_batches`` stop both packages at the same
    super-step with the same residual queue."""
    jp = jphold.build_program(num_lps=32, t_stop=50.0, capacity=256)
    tp = tphold.build_program(num_lps=32, t_stop=50.0, capacity=256)
    jsim = jp.build(backend="device", front_cap=8, stage_cap=8)
    tsim = tp.build(backend="device", device="cpu", front_cap=8, stage_cap=8)
    for kw in (dict(until=20.25), dict(max_batches=17)):
        assert_run_parity(jsim.run(jphold.initial_state(32), **kw),
                          tsim.run(tphold.initial_state(32), **kw))


def test_phold_overflow_drops_match_jax():
    """A queue too small for the population drops the same emits."""
    jp = jphold.build_program(num_lps=24, t_stop=20.0, capacity=16)
    tp = tphold.build_program(num_lps=24, t_stop=20.0, capacity=16)
    jres = jp.build(backend="device", front_cap=4, stage_cap=4).run(
        jphold.initial_state(24))
    tres = tp.build(backend="device", device="cpu", front_cap=4,
                    stage_cap=4).run(tphold.initial_state(24))
    assert_run_parity(jres, tres)
    assert tres.dropped > 0


def test_state_from_numpy_maps_u32_to_int64():
    state = state_from_numpy(
        {"c": np.zeros(3, np.int32), "h": np.uint32(2**32 - 1),
         "v": (np.float32(1.5),)}, "cpu")
    assert state["c"].dtype == torch.int32
    assert state["h"].dtype == torch.int64 and int(state["h"]) == 2**32 - 1
    assert state["v"][0].dtype == torch.float32


def test_run_does_not_mutate_initial_state():
    tp = tphold.build_program(num_lps=8, t_stop=10.0)
    state0 = tphold.initial_state(8)
    res = tp.build(backend="device", device="cpu").run(state0)
    assert int(state0["counts"].sum()) == 0
    assert int(res.state["counts"].sum()) == res.events


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = tphold.build_program(num_lps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prog.build(backend="device")


@pytest.mark.parametrize("kw", [
    dict(shards=2, placement="devices"),
    dict(shards=4, placement="devices", dispatch_mode="fused"),
    dict(shards=2, placement="devices", validate="cheap"),
    dict(shards=3, placement="devices", queue_mode="tiered3"),
    dict(shards=2, placement="devices", dispatch_mode="masked"),
])
def test_unported_modes_raise(kw):
    """``placement="devices"`` (ported, ROADMAP D1) in a process without
    a group of ``shards`` ranks: the process-group recipe."""
    prog = tphold.build_program(num_lps=4)
    with pytest.raises(ValueError, match="init_process_group"):
        prog.build(device="cpu", **kw)


def test_api_import_leaves_jax_out():
    code = ("import sys, repro_torch.api, repro_torch.core.engine, "
            "repro_torch.examples.phold, repro_torch.examples.poc, "
            "repro_torch.examples.mmc_network, repro_torch.core.vectorize, "
            "repro_torch.serving.scenarios, "
            "repro_torch.kernels.queue_front, repro_torch.kernels.ops, "
            "repro_torch.models, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.core.scheduler, repro_torch.core.composer, "
            "repro_torch.core.codec, repro_torch.poc, "
            "repro_torch.analysis, repro_torch.analysis.__main__; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.', "
            "'ml_dtypes.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)\b(?!_torch)", re.MULTILINE)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
