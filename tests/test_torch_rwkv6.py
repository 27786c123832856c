"""The port's RWKV6 blocks and rwkv6 LM against the JAX package's.

Both packages run ``rwkv6-1.6b.reduced()`` (2 layers of ``(rwkv,
rwkv_cm)``, d 64, rwkv_head_dim 16 so H 4, chunk 8, d_ff 128, vocab
256) from ONE set of weights: the JAX ``LM.init`` pytree, carried across
by ``params_from_jax``.  Activations and token inputs are numpy-seeded.

The JAX side runs in a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false``, as in
``tests/test_torch_lm.py``: XLA on the CPU otherwise keeps some bf16
intermediates (the token-shift mixes, the layer outputs) in f32.

The JAX LM runs its chunked ``lax.scan`` whatever ``attn_impl`` says;
the port's ``"blockwise"``/``"reference"`` run the same chunked form and
``"pallas"`` the ``rwkv6_scan`` wrapper (its plain sequential version on
the CPU), so all three are held to the one JAX output.

Tolerances, as in ``tests/test_torch_lm.py``: logits within 3e-2 (max
abs; bf16 activations may round to the neighbouring value in one
package); bf16 tensors within two bf16 ulps of the value.  f32 tensors
fed only by f32 arithmetic (the WKV state of one layer, from the same
bf16 input) within 1e-4 relative to their largest entry: sums in another
order and, for ``"pallas"``, the sequential instead of the chunked form.
States of the LM pass through bf16 layer inputs, so they get the bf16
tolerance scaled to their largest entry.
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
from repro.configs import list_configs as jlist_configs
from repro.models import LM as JLM
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_configs as tlist_configs
from repro_torch.models import LM as TLM
from repro_torch.models import ssm as tssm
from repro_torch.models.model import (
    cache_from_jax,
    params_from_jax,
    params_to_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
IMPLS = ("blockwise", "reference", "pallas")
LOGIT_TOL = 3e-2
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
F32_REL = 1e-4
B, T, T_LAYER, MAX_LEN, STEPS = 2, 16, 13, 32, 8
CACHE_LEAVES = ("x_att", "S", "x_ffn")


def _bf16(a):
    """f32 numpy values rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float32)


def _inputs():
    """The config, JAX weights, and the numpy inputs both packages share."""
    jcfg = jget_config("rwkv6-1.6b").reduced()
    params = JLM(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(13)
    D = jcfg.d_model
    H = D // jcfg.rwkv_head_dim
    K = jcfg.rwkv_head_dim
    data = {
        "tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32),
        "steps": rng.integers(0, jcfg.vocab_size,
                              (STEPS, B, 1)).astype(np.int32),
        # layer inputs: bf16 values, held as f32
        "x": _bf16(rng.standard_normal((B, T_LAYER, D))),
        "x_prev": _bf16(rng.standard_normal((B, 1, D))),
        "x1": _bf16(rng.standard_normal((B, 1, D))),
        "s0": rng.standard_normal((B, H, K, K)).astype(np.float32),
    }
    return jcfg, params, data


def _layer0(params, group):
    return jax.tree.map(lambda a: a[0], params["stages"][0]["l0"][group])


# ---------------------------------------------------------------------------
# the JAX side, run in a child process that rounds every bf16 op
# ---------------------------------------------------------------------------

def _write_jax_refs(path: str) -> None:
    jcfg, params, d = _inputs()
    out = {"embed_sum": np.asarray(params["embed"], np.float32).sum()}
    f32 = lambda a: np.asarray(a, np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    hd, chunk = jcfg.rwkv_head_dim, jcfg.rwkv_chunk
    mixer, ffn = _layer0(params, "mixer"), _layer0(params, "ffn")

    for name, kw in (("zero", {}),
                     ("prev", {"x_prev": bf(d["x_prev"])}),
                     ("s0", {"x_prev": bf(d["x_prev"]),
                             "s0": jnp.asarray(d["s0"])})):
        y, (xl, S) = jax.jit(functools.partial(
            jssm.rwkv6_attn, head_dim=hd, chunk=chunk, return_state=True,
            **kw))(mixer, bf(d["x"]))
        out[f"attn/{name}/y"], out[f"attn/{name}/x_last"] = f32(y), f32(xl)
        out[f"attn/{name}/S"] = f32(S)
    y, (xn, S) = jax.jit(functools.partial(
        jssm.rwkv6_attn_decode, head_dim=hd))(
            mixer, bf(d["x1"]), bf(d["x_prev"]), jnp.asarray(d["s0"]))
    out["one/y"], out["one/x"], out["one/S"] = f32(y), f32(xn), f32(S)
    for name, prev in (("zero", None), ("prev", bf(d["x_prev"]))):
        y, xl = jax.jit(functools.partial(
            jssm.rwkv6_channel_mix, return_state=True))(ffn, bf(d["x"]), prev)
        out[f"cm/{name}/y"], out[f"cm/{name}/x_last"] = f32(y), f32(xl)

    jm = JLM(jcfg)
    tokens = jnp.asarray(d["tokens"])
    out["forward"] = f32(jax.jit(jm.forward)(params, tokens)[0])
    logits, cache = jax.jit(functools.partial(jm.prefill, max_len=MAX_LEN))(
        params, tokens)
    out["prefill/logits"] = f32(logits)
    out["prefill/lengths"] = np.asarray(cache["lengths"])
    for name in CACHE_LEAVES:
        out[f"prefill/{name}"] = f32(cache["stages"][0]["l0"][name])
    step = jax.jit(jm.decode_step)
    for i, tok in enumerate(d["steps"]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        out[f"decode/{i}"] = f32(logits)
    for name in CACHE_LEAVES:
        out[f"decode/{name}"] = f32(cache["stages"][0]["l0"][name])
    out["decode/lengths"] = np.asarray(cache["lengths"])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_rwkv_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_rwkv6; "
            "test_torch_rwkv6._write_jax_refs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def setup(refs):
    jcfg, params, data = _inputs()
    tcfg = tget_config("rwkv6-1.6b").reduced()
    assert (jcfg.num_layers, jcfg.d_model, jcfg.rwkv_head_dim,
            jcfg.rwkv_chunk, jcfg.d_ff, jcfg.vocab_size) \
        == (2, 64, 16, 8, 128, 256)
    # the child drew the same weights
    assert np.asarray(params["embed"], np.float32).sum() == refs["embed_sum"]
    tree = jax.tree.map(np.asarray, params)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                state=params_from_jax(tcfg, tree), data=data)


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


# ---------------------------------------------------------------------------
# the blocks, layer 0's weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,case", [
    ("blockwise", "zero"), ("blockwise", "prev"), ("blockwise", "s0"),
    ("pallas", "zero"), ("pallas", "prev")])
def test_rwkv6_attn_matches_jax(setup, refs, impl, case):
    """T = 13 with chunk 8: a padded last chunk for the chunked form.
    The kernel route takes ``s0=None`` only (see
    ``test_pallas_route_refuses_s0``)."""
    cfg, d = setup["tcfg"], setup["data"]
    mixer = _tmodel(setup).layers[0].mixer
    kw = {}
    if case != "zero":
        kw["x_prev"] = _t(d["x_prev"])
    if case == "s0":
        kw["s0"] = torch.from_numpy(d["s0"].copy())
    y, (x_last, S) = tssm.rwkv6_attn(
        mixer, _t(d["x"]), head_dim=cfg.rwkv_head_dim, chunk=cfg.rwkv_chunk,
        return_state=True, impl=impl, **kw)
    assert y.shape == (B, T_LAYER, cfg.d_model)
    _check_bf16(y, refs[f"attn/{case}/y"], "y")
    assert torch.equal(x_last, _t(d["x"])[:, -1:])
    np.testing.assert_array_equal(_np(x_last), refs[f"attn/{case}/x_last"])
    _check_f32(S, refs[f"attn/{case}/S"], "S")


def test_pallas_route_refuses_s0(setup):
    cfg, d = setup["tcfg"], setup["data"]
    mixer = _tmodel(setup).layers[0].mixer
    with pytest.raises(ValueError, match="s0"):
        tssm.rwkv6_attn(mixer, _t(d["x"]), head_dim=cfg.rwkv_head_dim,
                        s0=torch.from_numpy(d["s0"].copy()), impl="pallas")


def test_rwkv6_attn_decode_matches_jax(setup, refs):
    cfg, d = setup["tcfg"], setup["data"]
    mixer = _tmodel(setup).layers[0].mixer
    y, (x_new, S) = tssm.rwkv6_attn_decode(
        mixer, _t(d["x1"]), _t(d["x_prev"]),
        torch.from_numpy(d["s0"].copy()), head_dim=cfg.rwkv_head_dim)
    _check_bf16(y, refs["one/y"], "y")
    np.testing.assert_array_equal(_np(x_new), refs["one/x"])
    _check_f32(S, refs["one/S"], "S")


@pytest.mark.parametrize("case", ["zero", "prev"])
def test_rwkv6_channel_mix_matches_jax(setup, refs, case):
    d = setup["data"]
    ffn = _tmodel(setup).layers[0].ffn
    prev = _t(d["x_prev"]) if case == "prev" else None
    y, x_last = tssm.rwkv6_channel_mix(ffn, _t(d["x"]), prev,
                                       return_state=True)
    _check_bf16(y, refs[f"cm/{case}/y"], "y")
    np.testing.assert_array_equal(_np(x_last), refs[f"cm/{case}/x_last"])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def _check_cache(cache, refs, prefix):
    [stage] = cache["stages"]
    assert list(stage) == ["l0"]
    assert sorted(stage["l0"]) == sorted(CACHE_LEAVES)
    for name in CACHE_LEAVES:
        got, want = stage["l0"][name], refs[f"{prefix}/{name}"]
        assert tuple(got.shape) == want.shape, name
        if name == "S":
            assert got.dtype == torch.float32
            scale = max(1.0, float(np.max(np.abs(want))))
            np.testing.assert_allclose(_np(got), want, err_msg=name,
                                       rtol=BF16_TOL["rtol"],
                                       atol=BF16_TOL["atol"] * scale)
        else:
            _check_bf16(got, want, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(setup, refs, impl):
    got, aux = _tmodel(setup, impl).forward(
        torch.from_numpy(setup["data"]["tokens"]))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _check_logits(got, refs["forward"], f"forward/{impl}")


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(setup, refs, impl):
    logits, cache = _tmodel(setup, impl).prefill(
        torch.from_numpy(setup["data"]["tokens"]), max_len=MAX_LEN)
    _check_logits(logits, refs["prefill/logits"], f"prefill/{impl}")
    assert cache["lengths"].dtype == torch.int32
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs["prefill/lengths"])
    _check_cache(cache, refs, "prefill")


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_jax(setup, refs, impl):
    """Prefill, then 8 decode steps on the port's own cache."""
    tm = _tmodel(setup, impl)
    _, cache = tm.prefill(torch.from_numpy(setup["data"]["tokens"]),
                          max_len=MAX_LEN)
    for i, tok in enumerate(setup["data"]["steps"]):
        logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
        assert logits.shape == (B, 1, setup["tcfg"].padded_vocab)
        _check_logits(logits, refs[f"decode/{i}"], f"decode/{impl} step {i}")
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs["decode/lengths"])
    _check_cache(cache, refs, "decode")


def test_decode_steps_from_the_jax_cache(setup, refs):
    """The JAX prefill cache carried across by ``cache_from_jax`` decodes
    as the port's own does."""
    tm = _tmodel(setup)
    tree = {"stages": [{"l0": {name: refs[f"prefill/{name}"]
                               for name in CACHE_LEAVES}}],
            "lengths": refs["prefill/lengths"]}
    cache = cache_from_jax(tree)
    cache["stages"][0]["l0"]["x_att"] = cache["stages"][0]["l0"][
        "x_att"].bfloat16()
    cache["stages"][0]["l0"]["x_ffn"] = cache["stages"][0]["l0"][
        "x_ffn"].bfloat16()
    for i, tok in enumerate(setup["data"]["steps"]):
        logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
        _check_logits(logits, refs[f"decode/{i}"], f"from jax: step {i}")


def test_decode_advances_idle_slots_as_jax(setup):
    """Every slot's state moves at every step, idle or not: a batch of
    two equals two batches of one."""
    tm = _tmodel(setup)
    toks = torch.from_numpy(setup["data"]["tokens"])
    _, both = tm.prefill(toks, max_len=MAX_LEN)
    step = torch.from_numpy(setup["data"]["steps"][0])
    logits, both = tm.decode_step(both, step)
    for b in range(B):
        _, one = tm.prefill(toks[b:b + 1], max_len=MAX_LEN)
        l1, one = tm.decode_step(one, step[b:b + 1])
        torch.testing.assert_close(l1, logits[b:b + 1], rtol=0, atol=1e-5)
        torch.testing.assert_close(one["stages"][0]["l0"]["S"][:, 0],
                                   both["stages"][0]["l0"]["S"][:, b],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# weights, configs, refusals
# ---------------------------------------------------------------------------

def test_params_round_trip_nested(setup):
    """The rwkv mixer's params nest (``mix/{r,k,v,w,g}``, ``ln_x``): the
    round trip holds through both levels."""
    tcfg, tree, state = setup["tcfg"], setup["tree"], setup["state"]
    assert "layers.0.mixer.mix.r" in state
    assert "layers.1.mixer.ln_x.scale" in state
    model = TLM(tcfg, device="cpu")
    model.load_state_dict(state)                 # every key, every shape
    assert model.layers[0].mixer["mix"]["w"].dtype == torch.float32
    assert model.layers[0].mixer["wr"].dtype == torch.bfloat16
    assert set(model.state_dict()) == set(state)
    back = params_to_numpy(tcfg, model.state_dict())

    def same(a, b):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    jax.tree.map(same, tree, back)
    again = params_from_jax(tcfg, back)
    assert again.keys() == state.keys()
    for key, t in state.items():
        u = again[key]
        if t.dtype == torch.bfloat16:     # bits came back as uint16
            u = u.view(torch.bfloat16)
        assert torch.equal(t, u), key


def test_port_init_matches_jax_init_rule():
    """``LM.init`` draws other numbers than JAX, but by the same rule:
    the constants equal, the random tensors at the same scale."""
    tcfg = tget_config("rwkv6-1.6b").reduced()
    jparams = JLM(jget_config("rwkv6-1.6b").reduced()).init(
        jax.random.PRNGKey(0))
    jm = _layer0(jparams, "mixer")
    tm = TLM(tcfg, device="cpu").init(0)
    p = tm.layers[0].mixer
    for s in ("r", "k", "v", "w", "g"):
        assert torch.equal(p["mix"][s], torch.full((tcfg.d_model,), 0.5))
    np.testing.assert_allclose(p["decay_base"].numpy(),
                               np.asarray(jm["decay_base"]), rtol=1e-6)
    assert torch.equal(p["ln_x"]["scale"], torch.ones(tcfg.d_model))
    assert torch.equal(p["ln_x"]["bias"], torch.zeros(tcfg.d_model))
    assert tuple(p["decay_A"].shape) == (tcfg.d_model, 64)
    for name in ("wr", "decay_A", "bonus_u"):
        want = float(np.std(np.asarray(jm[name], np.float32)))
        got = float(p[name].float().std())
        assert 0.7 * want < got < 1.3 * want, name
    assert tm.layers[0].ffn["mix_k"].eq(0.5).all()


def test_configs_equal_the_jax_configs():
    """The port's own copy of ``configs/`` (it may not import ``repro``)
    equals the JAX package's, full and reduced."""
    assert tlist_configs() == jlist_configs()
    for name in jlist_configs():
        for j, t in ((jget_config(name), tget_config(name)),
                     (jget_config(name).reduced(),
                      tget_config(name).reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.param_count() == j.param_count(), name
    cfg = tget_config("rwkv6-1.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.param_count()) \
        == (24, 2048, 64, 7168, 65536, 1_583_349_760)
    assert (cfg.reduced().rwkv_head_dim, cfg.reduced().rwkv_chunk) == (16, 8)


def test_rwkv_lm_defaults_to_the_card_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLM(tget_config("rwkv6-1.6b"))


def test_mamba_config_still_raises():
    """Mamba and MoE layers are ported (``tests/test_torch_jamba.py``), and
    MLA too (``tests/test_torch_mla.py``): the jamba and deepseek configs
    build."""
    model = TLM(tget_config("jamba-1.5-large-398b").reduced(), device="cpu")
    assert [lp.spec.mixer for lp in model.layers][:2] == ["gqa", "mamba"]
    model = TLM(tget_config("deepseek-v2-lite-16b").reduced(), device="cpu")
    assert [(lp.spec.mixer, lp.spec.ffn) for lp in model.layers] == [
        ("mla", "mlp"), ("mla", "moe"), ("mla", "moe")]


def test_f32_copy_runs_in_f32_and_scans_agree(setup):
    """A model cast with ``.float()`` keeps f32 activations end to end
    (caches included): ``chip_smoke.py`` holds the kernel path to the
    chunked plain scan on such a copy, where only the order of the f32
    sums differs."""
    rows = {}
    for impl in ("pallas", "blockwise"):
        tm = _tmodel(setup, impl).float()
        logits, cache = tm.prefill(torch.from_numpy(setup["data"]["tokens"]),
                                   max_len=MAX_LEN)
        for name in CACHE_LEAVES:
            assert cache["stages"][0]["l0"][name].dtype == torch.float32
        out = [logits]
        for tok in setup["data"]["steps"]:
            logits, cache = tm.decode_step(cache, torch.from_numpy(tok))
            out.append(logits[:, 0])
        rows[impl] = torch.stack(out)
    assert rows["pallas"].dtype == torch.float32
    torch.testing.assert_close(rows["pallas"], rows["blockwise"],
                               rtol=1e-5, atol=1e-5)
