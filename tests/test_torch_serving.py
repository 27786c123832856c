"""The port's serving engine against the JAX package's.

The scenarios of ``tests/test_substrates.py`` (decode-run fusion, fused
vs single-step decode, slot exhaustion) and ``tests/test_extended.py``
(slot splice isolation) run through both packages from ONE set of
weights: ``stablelm-12b.reduced()`` initialised by JAX, carried across
by ``params_from_jax``.  The fusion scenario runs ``rwkv6-1.6b.reduced()``
too, whose recurrent prompts are prefilled at their exact length.

The control plane must be exactly equal: ``decode_events``,
``fused_batches``, ``fused_events``, ``singles``, ``prefills``, and each
request's ``finish_time`` and output length.  Token streams must be
equal too.  That is asserted only where it is decidable: each scenario
runs on a weight seed whose every greedy choice has a JAX top-1/top-2
logit margin above 0.1 (the margins are recomputed and asserted here,
by teacher-forcing JAX's own stream), far above the ~3e-2 the two
packages' logits differ by (``tests/test_torch_lm.py``).  The fusion
scenario also runs the reduced jamba (``(gqa, mlp)``, ``(mamba, moe)``,
... one 8-layer block), a recurrent stack too: its prompts are at least
``d_conv - 1 = 3`` tokens, since a shorter one gives JAX a conv tail its
cache cannot hold (``repro/models/ssm.py:106``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.models import LM as TLM
from repro_torch.models.model import params_from_jax
from repro_torch.serving.engine import ServingEngine as TEngine

MARGIN = 0.1
SEED_J = 9
STAT_FIELDS = ("decode_events", "fused_batches", "fused_events", "singles",
               "prefills")

ARCH = "stablelm-12b"
RWKV = "rwkv6-1.6b"
JAMBA = "jamba-1.5-large-398b"


@functools.lru_cache(maxsize=None)
def _cfgs(arch: str):
    return jget_config(arch).reduced(), tget_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _weights(seed: int, arch: str = ARCH):
    jcfg, tcfg = _cfgs(arch)
    params = JLM(jcfg).init(jax.random.PRNGKey(seed))
    return params, params_from_jax(tcfg, jax.tree.map(np.asarray, params))


def _engines(seed: int, arch: str = ARCH, **kw):
    jcfg, tcfg = _cfgs(arch)
    params, state = _weights(seed, arch)
    jeng = JEngine(JLM(jcfg), params, **kw)
    tm = TLM(tcfg, device="cpu")
    tm.load_state_dict(state)
    return jeng, TEngine(tm, **kw)


@functools.lru_cache(maxsize=None)
def _jax_programs(max_len: int, arch: str = ARCH):
    m = JLM(_cfgs(arch)[0])
    return (jax.jit(m.forward),
            jax.jit(functools.partial(m.prefill, max_len=max_len)),
            jax.jit(m.decode_step))


def _greedy_margins(seed: int, prompt, stream, max_len: int,
                    arch: str = ARCH) -> list:
    """JAX's top-1/top-2 margin at every greedy choice of ``stream``,
    recomputed by teacher-forcing it: the first token from the forward
    of the prompt as the engine prefills it (padded to the 32-token
    bucket, or at its exact length for a recurrent model), the rest
    from decode steps on the prefilled cache."""
    params, _ = _weights(seed, arch)
    forward, prefill, step = _jax_programs(max_len, arch)
    recurrent = arch in (RWKV, JAMBA)
    toks = np.zeros((1, len(prompt) if recurrent else 32), np.int32)
    toks[0, :len(prompt)] = prompt
    logits, _ = forward(params, jnp.asarray(toks))
    rows = [np.asarray(logits[0, len(prompt) - 1])]
    _, cache = prefill(params, jnp.asarray(toks))
    cache["lengths"] = jnp.asarray([len(prompt)], jnp.int32)
    for tok in stream[:-1]:
        logits, cache = step(params, cache, jnp.asarray([[tok]], jnp.int32))
        rows.append(np.asarray(logits[0, 0]))
    margins = []
    for row, tok in zip(rows, stream):
        assert int(np.argmax(row)) == tok
        top2 = np.sort(row)[-2:]
        margins.append(float(top2[1] - top2[0]))
    return margins


def _check_same(jeng, teng, jstats, tstats, seed, max_len, arch=ARCH):
    for name in STAT_FIELDS:
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert sorted(tstats.compiled_programs) == sorted(jstats.compiled_programs)
    assert teng.requests.keys() == jeng.requests.keys()
    for rid, jr in jeng.requests.items():
        tr = teng.requests[rid]
        assert tr.done and jr.done
        assert tr.finish_time == jr.finish_time, rid
        assert len(tr.output) == len(jr.output), rid
        margins = _greedy_margins(seed, jr.prompt, jr.output, max_len,
                                  arch)
        assert min(margins) > MARGIN, (rid, margins)
        assert tr.output == jr.output, rid
    # one host read per decode batch that ran
    assert tstats.host_reads == tstats.decode_batches > 0


def test_serving_engine_fuses_decode_runs():
    kw = dict(max_slots=2, max_len=64, max_batch_len=4, arrival_lookahead=5.0)
    jeng, teng = _engines(1676, **kw)
    for eng in (jeng, teng):
        eng.submit(0, [5, 6, 7], max_new_tokens=6, at=0.0)
        eng.submit(1, [8, 9], max_new_tokens=6, at=6.0)
        eng.schedule_decode_grid(1.0, 40.0)
    jstats, tstats = jeng.run(), teng.run()
    assert tstats.fused_batches > 0 and tstats.mean_fused_length > 1.5
    _check_same(jeng, teng, jstats, tstats, 1676, 64)


def test_serving_rwkv6_fuses_decode_runs():
    """The fusion scenario on the reduced rwkv6: the control plane
    exactly equal, the token streams equal past the margin (weight seed
    27: every JAX greedy margin above 0.1, asserted)."""
    kw = dict(max_slots=2, max_len=64, max_batch_len=4, arrival_lookahead=5.0)
    jeng, teng = _engines(27, RWKV, **kw)
    for eng in (jeng, teng):
        eng.submit(0, [5, 6, 7], max_new_tokens=6, at=0.0)
        eng.submit(1, [8, 9, 10, 11, 12], max_new_tokens=6, at=6.0)
        eng.schedule_decode_grid(1.0, 40.0)
    jstats, tstats = jeng.run(), teng.run()
    assert tstats.fused_batches > 0 and tstats.mean_fused_length > 1.5
    _check_same(jeng, teng, jstats, tstats, 27, 64, RWKV)


def test_serving_jamba_fuses_decode_runs():
    """The fusion scenario on the reduced jamba: the control plane
    exactly equal, the token streams equal past the margin (weight seed
    9: every JAX greedy margin above 0.1, asserted)."""
    kw = dict(max_slots=2, max_len=64, max_batch_len=4, arrival_lookahead=5.0)
    jeng, teng = _engines(SEED_J, JAMBA, **kw)
    for eng in (jeng, teng):
        eng.submit(0, [5, 6, 7], max_new_tokens=6, at=0.0)
        eng.submit(1, [8, 9, 10, 11, 12], max_new_tokens=6, at=6.0)
        eng.schedule_decode_grid(1.0, 40.0)
    jstats, tstats = jeng.run(), teng.run()
    assert tstats.fused_batches > 0 and tstats.mean_fused_length > 1.5
    _check_same(jeng, teng, jstats, tstats, SEED_J, 64, JAMBA)


def test_serving_jamba_prefills_prompts_at_their_exact_length():
    """A hybrid prompt is not padded to a bucket either (the mamba
    layers' recurrence would run through the padding); the spliced slot
    holds exactly the prefill of the bare prompt, every leaf (K/V rows,
    mamba states and conv tails) through ``_splice_slot``."""
    jeng, teng = _engines(SEED_J, JAMBA, max_slots=2, max_len=64)
    for n in (3, 5, 31, 33, 200):
        assert teng._prefill_bucket(n) == jeng._prefill_bucket(n) == n
    prompt = [3, 1, 4, 1, 5]
    teng.submit(0, [9, 9, 9, 9], 4, at=0.0)
    teng.waiting.append(teng.requests[0])
    teng._h_prefill(None, 0.0, None)
    before = {lj: {n: t.clone() for n, t in layer.items()}
              for lj, layer in teng.cache["stages"][0].items()}
    teng.submit(1, prompt, 4, at=0.0)
    teng.waiting.append(teng.requests[1])
    teng._h_prefill(None, 0.0, None)
    slot, other = teng.requests[1].slot, teng.requests[0].slot
    _, own = teng.model.prefill(torch.tensor([prompt], dtype=torch.int32),
                                max_len=64)
    names = set()
    for lj, layer in teng.cache["stages"][0].items():
        for name, leaf in layer.items():
            names.add(name)
            assert torch.equal(leaf[:, slot],
                               own["stages"][0][lj][name][:, 0]), (lj, name)
            assert torch.equal(leaf[:, other], before[lj][name][:, other])
    assert names == {"k", "v", "h", "conv"}
    assert int(teng.cache["lengths"][slot]) == len(prompt)


def test_serving_rwkv6_prefills_prompts_at_their_exact_length():
    """A recurrent prompt is not padded to a bucket (padding would run
    through the recurrence), in both packages; the spliced slot holds
    exactly the prefill of the bare prompt."""
    jeng, teng = _engines(27, RWKV, max_slots=2, max_len=64)
    for n in (1, 5, 31, 33, 200):
        assert teng._prefill_bucket(n) == jeng._prefill_bucket(n) == n
    stable, _ = _engines(0, max_slots=1, max_len=64)
    assert stable._prefill_bucket(5) == 32
    prompt = [3, 1, 4, 1, 5]
    teng.submit(0, prompt, 4, at=0.0)
    teng.waiting.append(teng.requests[0])
    teng._h_prefill(None, 0.0, None)
    slot = teng.requests[0].slot
    _, own = teng.model.prefill(torch.tensor([prompt], dtype=torch.int32),
                                max_len=64)
    for name, leaf in teng.cache["stages"][0]["l0"].items():
        assert torch.equal(leaf[:, slot], own["stages"][0]["l0"][name][:, 0])
    padded = torch.zeros((1, 32), dtype=torch.int32)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    _, pad = teng.model.prefill(padded, max_len=64)
    assert not torch.equal(teng.cache["stages"][0]["l0"]["S"][:, slot],
                           pad["stages"][0]["l0"]["S"][:, 0])
    assert int(teng.cache["lengths"][slot]) == len(prompt)


@pytest.mark.parametrize("max_batch_len", [1, 4])
def test_serving_fused_matches_single_step_decode(max_batch_len):
    kw = dict(max_slots=1, max_len=64, max_batch_len=max_batch_len,
              arrival_lookahead=3.0)
    jeng, teng = _engines(41, **kw)
    for eng in (jeng, teng):
        eng.submit(0, [11, 12, 13, 14], max_new_tokens=8, at=0.0)
        eng.schedule_decode_grid(1.0, 30.0)
    jstats, tstats = jeng.run(), teng.run()
    _check_same(jeng, teng, jstats, tstats, 41, 64)
    # the k-step program gives the tokens of k single steps
    _, single = _engines(41, **dict(kw, max_batch_len=1))
    single.submit(0, [11, 12, 13, 14], max_new_tokens=8, at=0.0)
    single.schedule_decode_grid(1.0, 30.0)
    single.run()
    assert teng.requests[0].output == single.requests[0].output


def test_serving_slot_exhaustion_queues_requests():
    kw = dict(max_slots=1, max_len=64, max_batch_len=3, arrival_lookahead=2.0)
    jeng, teng = _engines(549, **kw)
    for eng in (jeng, teng):
        for rid in range(3):
            eng.submit(rid, [5 + rid, 6], max_new_tokens=3, at=float(rid))
        eng.schedule_decode_grid(1.0, 60.0)
    jstats, tstats = jeng.run(), teng.run()
    finish = [teng.requests[r].finish_time for r in range(3)]
    assert finish[0] < finish[1] < finish[2]      # served in order
    _check_same(jeng, teng, jstats, tstats, 549, 64)


def test_serving_prefill_splice_isolates_slots():
    """Prefilling slot 1 must not perturb slot 0's cache, in both
    packages; each slot holds exactly its own prefill.  (How close the
    two packages' prefill caches are is ``tests/test_torch_lm.py``'s
    business, with the JAX side rounding every bf16 op.)"""
    kw = dict(max_slots=2, max_len=64, max_batch_len=2)
    jeng, teng = _engines(0, **kw)
    snaps = {}
    prompts = ((0, [1, 2, 3]), (1, [4, 5]))
    for rid, prompt in prompts:
        for eng in (jeng, teng):
            eng.submit(rid, prompt, 4, at=0.0)
            eng.waiting.append(eng.requests[rid])
            eng._h_prefill(None, 0.0, None)
        if rid == 0:
            snaps["torch"] = {n: t.clone() for n, t in
                              teng.cache["stages"][0]["l0"].items()}
            snaps["jax"] = {n: np.asarray(a).copy() for n, a in
                            jeng.cache["stages"][0]["l0"].items()}
    for name in ("k", "v"):
        after = teng.cache["stages"][0]["l0"][name]
        assert torch.equal(after[:, 0], snaps["torch"][name][:, 0]), name
        np.testing.assert_array_equal(
            np.asarray(jeng.cache["stages"][0]["l0"][name])[:, 0],
            snaps["jax"][name][:, 0])
    for slot, (_, prompt) in enumerate(prompts):
        toks = torch.zeros((1, 32), dtype=torch.int32)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        _, own = teng.model.prefill(toks, max_len=64)
        for name in ("k", "v"):
            assert torch.equal(teng.cache["stages"][0]["l0"][name][:, slot],
                               own["stages"][0]["l0"][name][:, 0])
    np.testing.assert_array_equal(teng.cache["lengths"].numpy(),
                                  np.asarray(jeng.cache["lengths"]))
