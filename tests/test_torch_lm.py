"""The port's LM (``repro_torch.models``) against the JAX package's.

Both packages run ``stablelm-12b.reduced()`` (2 layers, d 64, 4 heads,
2 KV heads, head_dim 16, vocab 256) from ONE set of weights: the JAX
``LM.init`` pytree, carried across by ``params_from_jax``.  Token
inputs are numpy-seeded.

The JAX side runs in a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false``: XLA on the CPU
otherwise keeps some bf16 intermediates in f32, skipping roundings the
JAX program writes (and the port performs), which alone moves the
reduced model's logits by 0.027-0.038 (``scripts/torch_lm_gap.py``).
With the flag, XLA rounds where the program says.

Tolerance: logits within 3e-2 (max abs).  The activations are bf16, so
a projection or RoPE output may still round to the neighbouring bf16
value in one package and not the other (torch and XLA sum in different
orders and evaluate f32 sin/cos/pow to different ulps); logits here are
O(1); bf16 tensors (K/V, layer outputs) within two bf16 ulps of the
value.  Greedy tokens must agree wherever JAX's top-1/top-2 margin
exceeds 0.1, and the tests assert that most choices clear that margin,
so the token check is never vacuous.
"""

from __future__ import annotations

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
from repro.models.layers import embed_apply as jembed
from repro.models.layers import mlp_apply as jmlp
from repro.models.layers import unembed_apply as junembed
from repro_torch.configs import get_config as tget_config
from repro_torch.models import LM as TLM
from repro_torch.models import attention as tattn
from repro_torch.models.model import (
    cache_from_jax,
    params_from_jax,
    params_to_numpy,
)

ROOT = Path(__file__).resolve().parents[1]
IMPLS = ("blockwise", "reference", "pallas")
LOGIT_TOL = 3e-2
# bf16 tensors (K/V, layer outputs): two bf16 ulps of the value, since a
# value may round to the neighbouring bf16 in one package.
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
MARGIN = 0.1
B, T, MAX_LEN, STEPS = 2, 16, 32, 8


def _inputs():
    """The config, JAX weights and token inputs both packages share."""
    jcfg = jget_config("stablelm-12b").reduced()
    params = JLM(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return jcfg, params, tokens, steps


# ---------------------------------------------------------------------------
# the JAX side, run in a child process that rounds every bf16 op
# ---------------------------------------------------------------------------

def _jax_decode_step_pallas(jm, params, cache, tokens, per_layer=None):
    """``repro.models.LM.decode_step`` with the decode kernel: the JAX
    LM never passes ``impl`` to ``gqa_decode_apply`` (model.py:363), so
    this walks the layers the same way with ``impl="pallas"``.
    ``per_layer`` collects each layer's (h, y, k, v)."""
    cfg = jm.cfg
    lengths = cache["lengths"] + 1
    pos = (lengths - 1).astype(jnp.int32)[:, None]
    x = jembed(params["embed"], tokens)
    stage_p = params["stages"][0]["l0"]
    stage_c = dict(cache["stages"][0]["l0"])
    for li in range(cfg.num_layers):
        lp = jax.tree.map(lambda a: a[li], stage_p)
        h = jm.norm_apply(lp["mixer_norm"], x, eps=cfg.norm_eps)
        y, ck, cv = jattn.gqa_decode_apply(
            lp["mixer"], h, stage_c["k"][li], stage_c["v"][li], lengths,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=pos,
            rope_theta=cfg.rope_theta, impl="pallas")
        if per_layer is not None:
            per_layer.append((h, y, ck, cv))
        stage_c["k"] = stage_c["k"].at[li].set(ck)
        stage_c["v"] = stage_c["v"].at[li].set(cv)
        x = x + y
        h = jm.norm_apply(lp["ffn_norm"], x, eps=cfg.norm_eps)
        x = x + jmlp(lp["ffn"], h, activation=cfg.activation)
    x = jm.norm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    logits = jm._mask_pad(junembed(params["head"], x))
    return logits, {"stages": [{"l0": stage_c}], "lengths": lengths}


def _write_jax_refs(path: str) -> None:
    """Every JAX output the tests compare with, saved as f32 arrays."""
    jcfg, params, tokens, steps = _inputs()
    out = {"embed_sum": np.asarray(params["embed"], np.float32).sum()}
    f32 = lambda a: np.asarray(a, np.float32)
    layer = lambda c: c["stages"][0]["l0"]
    for impl in IMPLS:
        jm = JLM(jcfg, attn_impl=impl)
        out[f"forward/{impl}"] = f32(jax.jit(jm.forward)(
            params, jnp.asarray(tokens))[0])
        logits, cache = jax.jit(functools.partial(
            jm.prefill, max_len=MAX_LEN))(params, jnp.asarray(tokens))
        out[f"prefill/{impl}/logits"] = f32(logits)
        out[f"prefill/{impl}/lengths"] = np.asarray(cache["lengths"])
        for name in ("k", "v"):
            out[f"prefill/{impl}/{name}"] = f32(layer(cache)[name])
        if impl == "blockwise":
            shared = cache                  # every decode test starts here
    for name in ("k", "v"):
        out[f"shared/{name}"] = f32(layer(shared)[name])
    out["shared/lengths"] = np.asarray(shared["lengths"])

    for impl in IMPLS:
        jm = JLM(jcfg, attn_impl=impl)
        step = jax.jit(functools.partial(_jax_decode_step_pallas, jm)
                       if impl == "pallas" else jm.decode_step)
        cache = shared
        for i, tok in enumerate(steps):
            logits, cache = step(params, cache, jnp.asarray(tok))
            out[f"decode/{impl}/{i}"] = f32(logits)
        for name in ("k", "v"):
            out[f"decode/{impl}/{name}"] = f32(layer(cache)[name])
        out[f"decode/{impl}/lengths"] = np.asarray(cache["lengths"])

    layers = []
    _jax_decode_step_pallas(JLM(jcfg), params, shared,
                            jnp.asarray(steps[0]), layers)
    for li, (h, y, k, v) in enumerate(layers):
        for name, a in (("h", h), ("y", y), ("k", k), ("v", v)):
            out[f"layer/{li}/{name}"] = f32(a)

    out["forward/seq_parallel"] = f32(jax.jit(
        JLM(jcfg, seq_parallel=True).forward)(params, jnp.asarray(tokens))[0])

    jm = JLM(jcfg)
    step = jax.jit(jm.decode_step)
    cache = dict(shared, lengths=jnp.asarray([MAX_LEN, T], jnp.int32))
    for i, tok in enumerate(steps[:2]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        out[f"past_max/{i}"] = f32(logits)
    out["past_max/k"] = f32(layer(cache)["k"])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_lm; test_torch_lm._write_jax_refs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def setup(refs):
    jcfg, params, tokens, steps = _inputs()
    tcfg = tget_config("stablelm-12b").reduced()
    assert (jcfg.num_layers, jcfg.d_model, jcfg.num_heads,
            jcfg.num_kv_heads, jcfg.resolved_head_dim, jcfg.vocab_size) \
        == (2, 64, 4, 2, 16, 256)
    # the child drew the same weights
    assert np.asarray(params["embed"], np.float32).sum() == refs["embed_sum"]
    tree = jax.tree.map(np.asarray, params)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, tree=tree,
                state=params_from_jax(tcfg, tree), tokens=tokens,
                steps=steps)


def _tmodel(s, impl):
    m = TLM(s["tcfg"], attn_impl=impl, device="cpu")
    m.load_state_dict(s["state"])
    return m


def _shared_cache(refs, lengths=None) -> dict:
    """The port's copy of the shared prefilled cache (bf16 values)."""
    layer = {name: torch.from_numpy(refs[f"shared/{name}"].copy()).bfloat16()
             for name in ("k", "v")}
    lens = refs["shared/lengths"] if lengths is None else lengths
    return {"stages": [{"l0": layer}],
            "lengths": torch.tensor(lens, dtype=torch.int32)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_logits(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= LOGIT_TOL, f"{what}: max abs error {err}"


def _check_greedy(got, want, what) -> tuple[int, int]:
    """Greedy choices must agree where JAX's top-1/top-2 margin exceeds
    MARGIN.  Returns (choices, choices past the margin)."""
    got, want = _np(got), _np(want)
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear], err_msg=what)
    return len(clear), int(clear.sum())


# ---------------------------------------------------------------------------
# weights and caches carried across
# ---------------------------------------------------------------------------

def test_params_round_trip(setup):
    tcfg, tree, state = setup["tcfg"], setup["tree"], setup["state"]
    model = TLM(tcfg, device="cpu")
    model.load_state_dict(state)                 # every key, every shape
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm["scale"].dtype == torch.float32
    back = params_to_numpy(tcfg, state)

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


def test_cache_from_jax_keeps_layout_and_dtypes(setup):
    jm = JLM(setup["jcfg"])
    _, cache = jax.jit(functools.partial(jm.prefill, max_len=MAX_LEN))(
        setup["params"], jnp.asarray(setup["tokens"]))
    cache = jax.tree.map(np.asarray, cache)
    got = cache_from_jax(cache)
    assert got["lengths"].dtype == torch.int32
    np.testing.assert_array_equal(got["lengths"].numpy(), cache["lengths"])
    for name in ("k", "v"):
        t = got["stages"][0]["l0"][name]
        a = cache["stages"][0]["l0"][name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(setup, refs, impl):
    want = refs[f"forward/{impl}"]
    got, aux = _tmodel(setup, impl).forward(
        torch.from_numpy(setup["tokens"]))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _check_logits(got, want, f"forward/{impl}")
    n, clear = _check_greedy(got, want, f"forward/{impl}")
    assert clear >= n // 2, (clear, n)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(setup, refs, impl):
    got_logits, got_cache = _tmodel(setup, impl).prefill(
        torch.from_numpy(setup["tokens"]), max_len=MAX_LEN)
    _check_logits(got_logits, refs[f"prefill/{impl}/logits"],
                  f"prefill/{impl}")
    assert got_cache["lengths"].dtype == torch.int32
    np.testing.assert_array_equal(got_cache["lengths"].numpy(),
                                  refs[f"prefill/{impl}/lengths"])
    [stage] = got_cache["stages"]
    assert list(stage) == ["l0"] and sorted(stage["l0"]) == ["k", "v"]
    for name in ("k", "v"):
        g, w = stage["l0"][name], refs[f"prefill/{impl}/{name}"]
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), w, **BF16_TOL)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_jax(setup, refs, impl):
    """8 decode steps from the shared cache; ``pallas`` against JAX's
    decode step written out with ``gqa_decode_apply(impl="pallas")``."""
    tm = _tmodel(setup, impl)
    tcache = _shared_cache(refs)
    total = clear = 0
    for i, tok in enumerate(setup["steps"]):
        got, tcache = tm.decode_step(tcache, torch.from_numpy(tok))
        want = refs[f"decode/{impl}/{i}"]
        assert got.shape == (B, 1, setup["tcfg"].padded_vocab)
        _check_logits(got, want, f"decode/{impl} step {i}")
        n, c = _check_greedy(got, want, f"decode/{impl} step {i}")
        total, clear = total + n, clear + c
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  refs[f"decode/{impl}/lengths"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["stages"][0]["l0"][name]),
                                   refs[f"decode/{impl}/{name}"], **BF16_TOL)
    assert clear >= total // 2, (clear, total)


def test_pallas_decode_layer_matches_jax_kernel_path(setup, refs):
    """Per layer: the port's ``gqa_decode_apply(impl="pallas")`` against
    JAX's, from the same layer input and cache."""
    cfg = setup["tcfg"]
    tm = _tmodel(setup, "pallas")
    shared = _shared_cache(refs)
    lengths = shared["lengths"] + 1
    for li in range(cfg.num_layers):
        th = torch.from_numpy(refs[f"layer/{li}/h"].copy()).bfloat16()
        ty, tk, tv = tattn.gqa_decode_apply(
            tm.layers[li].mixer, th, shared["stages"][0]["l0"]["k"][li],
            shared["stages"][0]["l0"]["v"][li], lengths,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, positions=(lengths - 1)[:, None],
            rope_theta=cfg.rope_theta, impl="pallas")
        for name, got in (("y", ty), ("k", tk), ("v", tv)):
            np.testing.assert_allclose(_np(got), refs[f"layer/{li}/{name}"],
                                       err_msg=f"layer {li} {name}",
                                       **BF16_TOL)


# ---------------------------------------------------------------------------
# _scatter_token past max_len
# ---------------------------------------------------------------------------

def test_scatter_token_drops_rows_past_the_end_as_jax():
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((4, 6, 2, 8)).astype(np.float32)
    new = rng.standard_normal((4, 2, 8)).astype(np.float32)
    idx = np.array([0, 5, 6, -1], np.int32)    # in, last, past, negative
    want = np.asarray(jattn._scatter_token(jnp.asarray(cache),
                                           jnp.asarray(new),
                                           jnp.asarray(idx)))
    got = torch.from_numpy(cache.copy())
    tattn._scatter_token(got, torch.from_numpy(new), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[2], cache[2])     # dropped


def test_decode_drives_a_slot_past_max_len(setup, refs):
    """An idle serving slot's length keeps growing: decode past
    ``max_len`` must drop the K/V write (as JAX does) and not fault."""
    tcache = _shared_cache(refs, lengths=[MAX_LEN, T])
    tm = _tmodel(setup, "blockwise")
    k_before = tcache["stages"][0]["l0"]["k"].clone()
    for i, tok in enumerate(setup["steps"][:2]):
        got, tcache = tm.decode_step(tcache, torch.from_numpy(tok))
        _check_logits(got, refs[f"past_max/{i}"], "decode past max_len")
    assert tcache["lengths"].tolist() == [MAX_LEN + 2, T + 2]
    k_after = tcache["stages"][0]["l0"]["k"]
    assert torch.equal(k_after[:, 0], k_before[:, 0])   # slot 0: no write
    assert not torch.equal(k_after[:, 1], k_before[:, 1])
    np.testing.assert_allclose(_np(k_after), refs["past_max/k"], **BF16_TOL)


def test_lm_defaults_to_the_card_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLM(tget_config("stablelm-12b").reduced())


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-vl-72b"])
def test_unported_layers_raise(arch):
    """``seq_parallel``, the last option of the JAX ``LM`` to be ported
    (ROADMAP D2), builds on the MLA and M-RoPE configs and, with no mesh
    registered, is the identity, as JAX's constraint is on one device:
    the same weights give bit-identical logits with and without it (its
    numbers on a mesh: ``tests/test_torch_seq_parallel.py``)."""
    cfg = tget_config(arch).reduced()
    plain = TLM(cfg, device="cpu").init(0)
    sp = TLM(cfg, seq_parallel=True, device="cpu")
    sp.load_state_dict(plain.state_dict())
    tokens = torch.arange(16, dtype=torch.int32).reshape(1, 16) % 7
    assert torch.equal(sp.forward(tokens)[0], plain.forward(tokens)[0])


def test_seq_parallel_forward_matches_jax(setup, refs):
    """``LM(seq_parallel=True)`` on one device against JAX's."""
    m = TLM(setup["tcfg"], seq_parallel=True, device="cpu")
    m.load_state_dict(setup["state"])
    logits, _ = m.forward(torch.from_numpy(setup["tokens"]))
    _check_logits(logits, refs["forward/seq_parallel"], "seq_parallel")
    _check_logits(logits, refs["forward/blockwise"], "seq_parallel=False")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "qwen2-vl-72b"])
def test_mla_and_m_rope_configs_build_and_run(arch):
    """MLA (deepseek-v2-lite) and M-RoPE (qwen2-vl) configs build, with
    JAX's param tree leaf for leaf (path, shape, dtype), and run (their
    numbers: ``tests/test_torch_mla.py``, ``tests/test_torch_mrope.py``)."""
    from repro_torch.core.tree import key_leaves
    model = TLM(tget_config(arch).reduced(), device="cpu").init(0)
    shapes = jax.eval_shape(JLM(jget_config(arch).reduced()).init,
                            jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    got = list(key_leaves(model.stacked_params()))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (path, t), (_, want) in zip(got, flat):
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype).split(".")[1] == want.dtype.name, path
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    logits, cache = model.prefill(tokens, max_len=12)
    assert bool(torch.isfinite(logits).all())
    logits, cache = model.decode_step(cache, tokens[:, :1])
    assert bool(torch.isfinite(logits).all())
    assert cache["lengths"].tolist() == [9]
