"""The port's mamba blocks and jamba LM against the JAX package's.

Three configurations, each from ONE set of weights (the JAX ``LM.init``
pytree, drawn in the JAX child process below and carried across by
``params_from_jax``), with numpy-seeded token and activation inputs:

* ``block`` — ``jamba-1.5-large-398b.reduced()``: one full 8-layer block
  ``[(gqa, mlp), (mamba, moe), (mamba, mlp), ...]``, d 64, 4 heads of
  16 (2 KV heads), mamba d_state 4 (d_inner 128, dt_rank 4, chunk 8),
  4 experts top-2 with capacity factor 2 (dropless), vocab 256;
* ``trunc`` — the same config cut to its first two layers, ``[(gqa,
  mlp), (mamba, moe)]``: what ``chip_smoke.py`` serves at full width;
* ``granite`` — ``granite-moe-1b-a400m.reduced()``: two ``(gqa, moe)``
  layers, tied embeddings.

This file runs ``block``; ``tests/test_torch_jamba_trunc.py`` runs
``trunc`` and the mamba layer itself (its layer 1),
``tests/test_torch_granite_moe.py`` runs ``granite``, both with the
helpers here (one file a configuration, so that each JAX child stays
well under a minute).

The JAX side runs in a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
``tests/test_torch_lm.py``.  The JAX LM runs its chunked
``associative_scan`` whatever ``attn_impl`` says; the port's three impls
are all held to that one output in ``forward`` and ``prefill``.  At
decode the JAX LM never passes ``impl`` to ``gqa_decode_apply``
(``models/model.py:363``), while the port's ``"pallas"`` runs the decode
kernel; so the port's ``"pallas"`` decode is held to a JAX decode step
written out with ``gqa_decode_apply(impl="pallas")``, as
``tests/test_torch_lm.py`` does.  The two plain decode attentions round
differently (one bf16 ulp in most elements of a head's output), and the
random reduced jamba carries that to 0.07 in its logits.  This file
decodes ``block`` with the plain impls; the kernel route is decoded on
``trunc`` and ``granite`` in ``tests/test_torch_jamba_trunc.py``.

Tolerances, as in ``tests/test_torch_lm.py`` and
``tests/test_torch_rwkv6.py``: logits within 3e-2 (max abs); bf16
tensors (K/V, conv tails, layer outputs) within two bf16 ulps of the
value; the mamba state ``h`` of one layer from the same bf16 input within
1e-4 of its largest entry (f32 sums in another order: the sequential
recurrence against JAX's tree scan); states of the LM, which pass through
bf16 layer inputs, within the bf16 tolerance scaled to their largest
entry; the MoE aux loss within 1e-5 relative.  MoE routing is a
discontinuous function of its input: each LM test prints the smallest
k-th/(k+1)-th router logit gap of the port's run (``pytest -s``), so that
a failure from a near tie can be told apart from a port fault.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models.layers import embed_apply as jembed
from repro.models.layers import unembed_apply as junembed
from repro_torch.configs import get_config as tget_config
from repro_torch.models import LM as TLM
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.model import (
    cache_from_jax,
    params_from_jax,
    params_to_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
IMPLS = ("blockwise", "reference", "pallas")
CASES = ("block",)
LOGIT_TOL = 3e-2
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
F32_REL = 1e-4
AUX_REL = 1e-5
B, T, T_LAYER, MAX_LEN, STEPS = 2, 16, 13, 32, 6


def _cfg(get_config, case):
    if case == "granite":
        return get_config("granite-moe-1b-a400m").reduced()
    cfg = get_config("jamba-1.5-large-398b").reduced()
    if case == "trunc":
        cfg = dataclasses.replace(cfg, num_layers=2,
                                  block_pattern=cfg.block_pattern[:2])
    return cfg


def _bf16(a):
    """f32 numpy values rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float32)


@functools.lru_cache(maxsize=None)
def _data(case):
    """The numpy inputs both packages share."""
    jcfg = _cfg(jget_config, case)
    rng = np.random.default_rng(14)
    data = {
        "tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32),
        "steps": rng.integers(0, jcfg.vocab_size,
                              (STEPS, B, 1)).astype(np.int32),
    }
    if jcfg.mamba is not None:
        mm = jcfg.mamba
        I = mm.d_inner(jcfg.d_model)
        data.update({
            "x": _bf16(rng.standard_normal((B, T_LAYER, jcfg.d_model))),
            "x1": _bf16(rng.standard_normal((B, 1, jcfg.d_model))),
            "h0": rng.standard_normal((B, I, mm.d_state)).astype(np.float32),
            "conv0": _bf16(rng.standard_normal((B, mm.d_conv - 1, I))),
        })
    return data


def _params_tree(case, refs):
    """The child's JAX weights, rebuilt as the ``LM.init`` pytree of
    numpy arrays (bf16 leaves travel as their uint16 bits)."""
    jcfg = _cfg(jget_config, case)
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    arrays = []
    for i, leaf in enumerate(leaves):
        a = refs[f"{case}/param/{i}"]
        arrays.append(a.view(jnp.bfloat16) if leaf.dtype == jnp.bfloat16
                      else a)
        assert arrays[-1].shape == leaf.shape and \
            arrays[-1].dtype == leaf.dtype
    return jax.tree.unflatten(treedef, arrays)


def _mamba_layer(params):
    """The JAX params of the first mamba mixer (layer l1)."""
    return jax.tree.map(lambda a: a[0], params["stages"][0]["l1"]["mixer"])


def _cache_leaves(cache):
    for si, stage in enumerate(cache["stages"]):
        for lj, layer in stage.items():
            for name, leaf in layer.items():
                yield f"{si}/{lj}/{name}", leaf


# ---------------------------------------------------------------------------
# the JAX side, run in a child process that rounds every bf16 op
# ---------------------------------------------------------------------------

def _jax_decode_step_pallas(jm, params, cache, tokens):
    """``repro.models.LM.decode_step`` with the decode kernel: the JAX
    LM never passes ``impl`` to ``gqa_decode_apply``, so this walks the
    layers the same way, with ``impl="pallas"`` for attention and JAX's
    own ``_mixer_decode``/``_ffn_decode`` for everything else."""
    cfg = jm.cfg
    lengths = cache["lengths"] + 1
    pos = (lengths - 1).astype(jnp.int32)[:, None]
    x = jembed(params["embed"], tokens)
    stages = []
    for (pattern, repeat), sp, sc in zip(jm.stages, params["stages"],
                                         cache["stages"]):
        sc = {lj: dict(c) for lj, c in sc.items()}
        for li in range(repeat):
            for j, spec in enumerate(pattern):
                lp = jax.tree.map(lambda a: a[li], sp[f"l{j}"])
                lc = {k: v[li] for k, v in sc[f"l{j}"].items()}
                if spec.mixer == "gqa":
                    h = jm.norm_apply(lp["mixer_norm"], x, eps=cfg.norm_eps)
                    y, ck, cv = jattn.gqa_decode_apply(
                        lp["mixer"], h, lc["k"], lc["v"], lengths,
                        num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim, positions=pos,
                        rope_theta=cfg.rope_theta, impl="pallas")
                    x, new = x + y, dict(lc, k=ck, v=cv)
                else:
                    x, new = jm._mixer_decode(spec, lp, x, lc, lengths, pos)
                x, new = jm._ffn_decode(spec, lp, x, new)
                for k, v in new.items():
                    sc[f"l{j}"][k] = sc[f"l{j}"][k].at[li].set(
                        v.astype(sc[f"l{j}"][k].dtype))
        stages.append(sc)
    x = jm.norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = jm._mask_pad(junembed(head, x))
    return logits, {"stages": stages, "lengths": lengths}


def _write_jax_refs(path: str, cases: str) -> None:
    """Every JAX output the tests of ``cases`` (comma-separated) compare
    with, and the weights, saved as numpy arrays."""
    out = {}
    f32 = lambda a: np.asarray(a, np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    for case in cases.split(","):
        jcfg, d = _cfg(jget_config, case), _data(case)
        params = JLM(jcfg).init(jax.random.PRNGKey(0))
        for i, leaf in enumerate(jax.tree.leaves(params)):
            a = np.asarray(leaf)
            out[f"{case}/param/{i}"] = a.view(np.uint16) \
                if a.dtype == jnp.bfloat16 else a
        jm = JLM(jcfg)
        tokens = jnp.asarray(d["tokens"])
        logits, aux = jax.jit(jm.forward)(params, tokens)
        out[f"{case}/forward"], out[f"{case}/aux"] = f32(logits), f32(aux)
        logits, cache = jax.jit(functools.partial(
            jm.prefill, max_len=MAX_LEN))(params, tokens)
        out[f"{case}/prefill/logits"] = f32(logits)
        out[f"{case}/prefill/lengths"] = np.asarray(cache["lengths"])
        for key, leaf in _cache_leaves(cache):
            out[f"{case}/prefill/{key}"] = f32(leaf)
        prefilled = cache
        steps = {"decode": jax.jit(jm.decode_step)}
        if case != "block":
            steps["decode_pallas"] = jax.jit(functools.partial(
                _jax_decode_step_pallas, jm))
        for name, step in steps.items():
            cache = prefilled
            for i, tok in enumerate(d["steps"]):
                logits, cache = step(params, cache, jnp.asarray(tok))
                out[f"{case}/{name}/{i}"] = f32(logits)
            for key, leaf in _cache_leaves(cache):
                out[f"{case}/{name}/{key}"] = f32(leaf)
            out[f"{case}/{name}/lengths"] = np.asarray(cache["lengths"])
        if case != "trunc":
            continue
        mm = jcfg.mamba
        mixer = _mamba_layer(params)
        kw = dict(d_state=mm.d_state, d_conv=mm.d_conv, chunk=mm.chunk,
                  return_state=True)
        for name, extra in (("zero", {}),
                            ("state", {"h0": jnp.asarray(d["h0"]),
                                       "conv0": bf(d["conv0"])})):
            y, (h, conv) = jax.jit(functools.partial(
                jssm.mamba_apply, **kw, **extra))(mixer, bf(d["x"]))
            out[f"mamba/{name}/y"] = f32(y)
            out[f"mamba/{name}/h"] = f32(h)
            out[f"mamba/{name}/conv"] = f32(conv)
        y, st = jax.jit(functools.partial(
            jssm.mamba_decode_step, d_state=mm.d_state, d_conv=mm.d_conv))(
                mixer, bf(d["x1"]), {"h": jnp.asarray(d["h0"]),
                                     "conv": bf(d["conv0"])})
        out["mamba/one/y"] = f32(y)
        out["mamba/one/h"], out["mamba/one/conv"] = f32(st["h"]), \
            f32(st["conv"])
    np.savez(path, **out)


def jax_refs(tmp_path_factory, cases) -> dict:
    """Run :func:`_write_jax_refs` for ``cases`` in a child process that
    rounds every bf16 op, and load what it wrote."""
    path = tmp_path_factory.mktemp("jax_jamba_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_jamba; "
            "test_torch_jamba._write_jax_refs(sys.argv[2], sys.argv[3])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path),
         ",".join(cases)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def make_setup(refs):
    """case -> the configs, the JAX weights (numpy pytree), the port's
    state dict and the shared inputs."""
    @functools.lru_cache(maxsize=None)
    def setup(case):
        tcfg = _cfg(tget_config, case)
        tree = _params_tree(case, refs)
        return dict(tcfg=tcfg, tree=tree, state=params_from_jax(tcfg, tree),
                    data=_data(case))
    return setup


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return jax_refs(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def setup(refs):
    return make_setup(refs)


@pytest.fixture
def gaps(monkeypatch):
    """The smallest k-th/(k+1)-th router logit gap of every MoE call the
    port makes during a test."""
    seen = []

    def record(fn):
        def wrapped(params, x, *, num_experts, top_k, **kw):
            logits = tmoe.proj(x.reshape(-1, x.shape[-1]).float(),
                               params["router"])
            top = torch.sort(logits.double(), dim=-1, descending=True)[0]
            seen.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
            return fn(params, x, num_experts=num_experts, top_k=top_k, **kw)
        return wrapped

    monkeypatch.setattr(tmodel, "moe_apply", record(tmoe.moe_apply))
    monkeypatch.setattr(tmodel, "moe_apply_dense",
                        record(tmoe.moe_apply_dense))
    return seen


def _tmodel(s, impl="blockwise"):
    m = TLM(s["tcfg"], attn_impl=impl, device="cpu")
    m.load_state_dict(s["state"])
    return m


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_logits(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= LOGIT_TOL, f"{what}: max abs error {err}"


def _check_bf16(got, want, what):
    assert got.dtype == torch.bfloat16, what
    np.testing.assert_allclose(_np(got), want, err_msg=what, **BF16_TOL)


def _check_f32(got, want, what, rel=F32_REL):
    assert got.dtype == torch.float32, what
    got = _np(got)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), f"{what}: {err}"


def _check_cache(cache, refs, prefix):
    keys = [k for k in refs if k.startswith(prefix + "/")
            and k.count("/") == prefix.count("/") + 3]
    got = dict(_cache_leaves(cache))
    assert sorted(f"{prefix}/{k}" for k in got) == sorted(keys)
    for key, leaf in got.items():
        want = refs[f"{prefix}/{key}"]
        assert tuple(leaf.shape) == want.shape, key
        if key.endswith("/h"):
            assert leaf.dtype == torch.float32
            scale = max(1.0, float(np.max(np.abs(want))))
            np.testing.assert_allclose(_np(leaf), want, err_msg=key,
                                       rtol=BF16_TOL["rtol"],
                                       atol=BF16_TOL["atol"] * scale)
        else:
            _check_bf16(leaf, want, key)


def _check_gaps(gaps, what):
    assert gaps, f"{what}: no MoE layer ran"
    print(f"{what}: smallest router k-th/(k+1)-th logit gap {min(gaps):.3g}")


# ---------------------------------------------------------------------------
# the mamba block, the first mamba layer's weights
# ---------------------------------------------------------------------------

def test_short_segment_conv_tail():
    """A segment shorter than d_conv - 1 keeps the state's older rows in
    its tail (JAX would return a short tail that its cache cannot hold:
    ``ssm.py:106``); at d_conv - 1 tokens or more the tail is the last
    inputs, as JAX takes them."""
    xs = torch.arange(2 * 2 * 3, dtype=torch.float32).reshape(2, 2, 3)
    conv0 = -torch.ones((2, 3, 3))
    tail = tssm._conv_tail(xs, 4, conv0)
    assert torch.equal(tail[:, :1], conv0[:, 2:])
    assert torch.equal(tail[:, 1:], xs)
    assert torch.equal(tssm._conv_tail(xs, 4)[:, 0], torch.zeros(2, 3))
    long = torch.randn(2, 5, 3)
    assert torch.equal(tssm._conv_tail(long, 4), long[:, 2:])


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------

def check_forward(setup, refs, gaps, case, impl):
    """The port's ``forward`` (logits and the summed MoE aux loss)
    against JAX's."""
    got, aux = _tmodel(setup(case), impl).forward(
        torch.from_numpy(setup(case)["data"]["tokens"]))
    _check_gaps(gaps, f"{case}/forward/{impl}")
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(refs[f"{case}/aux"]),
                               rtol=AUX_REL)
    _check_logits(got, refs[f"{case}/forward"], f"{case}/forward/{impl}")


def check_prefill(setup, refs, gaps, case, impl):
    """The port's ``prefill`` (last logits and every cache leaf) against
    JAX's."""
    s = setup(case)
    logits, cache = _tmodel(s, impl).prefill(
        torch.from_numpy(s["data"]["tokens"]), max_len=MAX_LEN)
    _check_gaps(gaps, f"{case}/prefill/{impl}")
    _check_logits(logits, refs[f"{case}/prefill/logits"],
                  f"{case}/prefill/{impl}")
    assert cache["lengths"].dtype == torch.int32
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs[f"{case}/prefill/lengths"])
    _check_cache(cache, refs, f"{case}/prefill")


def check_decode(setup, refs, gaps, case, impl):
    """Prefill, then decode steps on the port's own cache (MoE dropless
    at decode, with capacity in the prefill, as JAX); the kernel route
    against JAX's decode with the Pallas decode kernel."""
    s = setup(case)
    ref = "decode_pallas" if impl == "pallas" else "decode"
    tm = _tmodel(s, impl)
    _, cache = tm.prefill(torch.from_numpy(s["data"]["tokens"]),
                          max_len=MAX_LEN)
    for i, tok in enumerate(s["data"]["steps"]):
        logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
        assert logits.shape == (B, 1, s["tcfg"].padded_vocab)
        _check_logits(logits, refs[f"{case}/{ref}/{i}"],
                      f"{case}/{ref}/{impl} step {i}")
    _check_gaps(gaps, f"{case}/{ref}/{impl}")
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs[f"{case}/{ref}/lengths"])
    _check_cache(cache, refs, f"{case}/{ref}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(setup, refs, gaps, case, impl):
    check_forward(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(setup, refs, gaps, case, impl):
    check_prefill(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", ("blockwise", "reference"))
@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_jax(setup, refs, gaps, case, impl):
    check_decode(setup, refs, gaps, case, impl)


def test_decode_steps_from_the_jax_cache(setup, refs):
    """The JAX prefill cache carried across by ``cache_from_jax`` decodes
    as the port's own does (the bf16 leaves come back as bf16)."""
    s = setup("block")
    tm = _tmodel(s)
    own = tm.init_cache(B, MAX_LEN)
    tree = {"stages": [{lj: {name: refs[f"block/prefill/0/{lj}/{name}"]
                             for name in layer}
                        for lj, layer in own["stages"][0].items()}],
            "lengths": refs["block/prefill/lengths"]}
    cache = cache_from_jax(tree)
    for lj, layer in cache["stages"][0].items():
        for name in layer:
            layer[name] = layer[name].to(own["stages"][0][lj][name].dtype)
    for i, tok in enumerate(s["data"]["steps"]):
        logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
        _check_logits(logits, refs[f"block/decode/{i}"], f"from jax: {i}")


def test_decode_advances_idle_slots_as_jax(setup):
    """Every slot's mamba state moves at every step: a batch of two
    equals two batches of one (the dense MoE routes each token alone)."""
    s = setup("block")
    tm = _tmodel(s)
    toks = torch.from_numpy(s["data"]["tokens"])
    _, both = tm.prefill(toks, max_len=MAX_LEN)
    step = torch.from_numpy(s["data"]["steps"][0])
    logits, both = tm.decode_step(both, step)
    for b in range(B):
        _, one = tm.prefill(toks[b:b + 1], max_len=MAX_LEN)
        l1, one = tm.decode_step(one, step[b:b + 1])
        torch.testing.assert_close(l1, logits[b:b + 1], rtol=0, atol=1e-5)
        for name in ("h", "conv"):
            torch.testing.assert_close(
                one["stages"][0]["l1"][name][:, 0].float(),
                both["stages"][0]["l1"][name][:, b].float(),
                rtol=1e-5, atol=1e-5)


def test_f32_copy_runs_in_f32_and_scans_agree(setup):
    """A model cast with ``.float()`` keeps f32 activations end to end
    (the conv tail included), and the kernel route and the chunked plain
    scan then agree to f32 summation order."""
    s = setup("block")
    rows = {}
    for impl in ("pallas", "blockwise"):
        tm = _tmodel(s, impl).float()
        logits, cache = tm.prefill(torch.from_numpy(s["data"]["tokens"]),
                                   max_len=MAX_LEN)
        for name in ("h", "conv"):
            assert cache["stages"][0]["l1"][name].dtype == torch.float32
        out = [logits]
        for tok in s["data"]["steps"]:
            logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
            out.append(logits[:, 0])
        rows[impl] = torch.stack(out)
    torch.testing.assert_close(rows["pallas"], rows["blockwise"],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# weights and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_params_round_trip_with_experts_and_mamba(setup, case):
    check_round_trip(setup, case)


def check_round_trip(setup, case):
    """The stacked experts (``[repeat, E, ...]`` in JAX) and the mamba
    leaves make the round trip; JAX's empty mamba ``meta`` group carries
    nothing."""
    s = setup(case)
    tcfg, tree, state = s["tcfg"], s["tree"], s["state"]
    moe_layer = 1 if case == "block" else 0
    assert f"layers.{moe_layer}.ffn.experts.gate" in state
    assert tuple(state[f"layers.{moe_layer}.ffn.experts.down"].shape) == (
        tcfg.moe.num_experts, tcfg.moe.d_ff_expert, tcfg.d_model)
    if case == "block":
        assert "layers.1.mixer.A_log" in state
        assert not any(".meta" in key for key in state)
    model = TLM(tcfg, device="cpu")
    model.load_state_dict(state)
    assert model.layers[moe_layer].ffn["router"].dtype == torch.float32
    assert set(model.state_dict()) == set(state)
    back = params_to_numpy(tcfg, model.state_dict())
    want = jax.tree.map(lambda a: a, tree)
    for unit in want["stages"]:
        for layer in unit.values():
            layer["mixer"].pop("meta", None)

    def same(a, b):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    jax.tree.map(same, want, back)
    again = params_from_jax(tcfg, back)
    assert again.keys() == state.keys()
    for key, t in state.items():
        u = again[key]
        if t.dtype == torch.bfloat16:
            u = u.view(torch.bfloat16)
        assert torch.equal(t, u), key


def test_port_init_matches_jax_init_rule(setup):
    """``LM.init`` draws other numbers than JAX, but by the same rule:
    the constants equal, the random tensors at the same scale."""
    tcfg = tget_config("jamba-1.5-large-398b").reduced()
    jparams = setup("block")["tree"]
    jm = _mamba_layer(jparams)
    tm = TLM(tcfg, device="cpu").init(0)
    p = tm.layers[1].mixer
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_array_equal(_np(p[name]),
                                      np.asarray(jm[name], np.float32))
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj",
                 "dt_bias"):
        a = np.asarray(jm[name], np.float32)
        assert tuple(p[name].shape) == a.shape, name
        assert p[name].dtype == (torch.float32 if a.dtype == np.float32
                                 and name == "dt_bias" else torch.bfloat16)
        want, got = float(np.std(a)), float(p[name].float().std())
        assert 0.7 * want < got < 1.3 * want, name
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert 0.001 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6
    ffn = tm.layers[1].ffn
    jffn = jax.tree.map(lambda a: a[0], jparams["stages"][0]["l1"]["ffn"])
    for name in ("gate", "up", "down"):
        a = np.asarray(jffn["experts"][name], np.float32)
        assert tuple(ffn["experts"][name].shape) == a.shape
        want = float(np.std(a))
        assert 0.7 * want < float(ffn["experts"][name].float().std()) \
            < 1.3 * want


def test_jamba_truncation_has_the_full_width_sizes():
    """The two-layer truncation ``chip_smoke.py`` serves: published
    widths, depth cut from 72 layers to 2, 11.9 B parameters."""
    cfg = tget_config("jamba-1.5-large-398b")
    cut = dataclasses.replace(cfg, num_layers=2,
                              block_pattern=cfg.block_pattern[:2])
    assert [(s.mixer, s.ffn) for s in cut.block_pattern] == [
        ("gqa", "mlp"), ("mamba", "moe")]
    assert cut.param_count() == 11_912_822_784
    assert (cut.d_model, cut.num_heads, cut.num_kv_heads,
            cut.resolved_head_dim, cut.d_ff, cut.vocab_size) == \
        (8192, 64, 8, 128, 24576, 65536)
    assert (cut.moe.num_experts, cut.moe.top_k, cut.moe.capacity_factor,
            cut.mamba.d_state, cut.mamba.d_conv,
            cut.mamba.d_inner(cut.d_model)) == (16, 2, 1.25, 16, 4, 16384)
    # the port's parameter shapes hold exactly that many numbers
    shapes = {**tssm.mamba_weight_shapes(d_model=8192),
              **{f"moe.{k}": v for k, v in tmoe.moe_weight_shapes(
                  d_model=8192, d_ff_expert=24576, num_experts=16).items()}}
    assert shapes["dt_proj"][0] == (512, 16384)
    assert shapes["x_proj"][0] == (16384, 512 + 32)
