"""The port's MLA layers and deepseek-v2-lite LM against the JAX package's.

``deepseek-v2-lite-16b.reduced()``: three layers, ``(mla, mlp)`` then two
``(mla, moe)``, d 64, 4 heads, MLA kv_lora_rank 32, qk_nope 16, qk_rope
8, v 16 (qk head dim 24), 4 experts top-2 with one shared expert and
capacity factor 2 (dropless), vocab 256, untied head.  Both packages run
ONE set of weights: the JAX ``LM.init`` pytree, drawn in the JAX child
process below and carried across by ``params_from_jax``.  Token and
activation inputs are numpy-seeded.

The JAX side runs in a child process with
``--xla_allow_excess_precision=false`` (see ``tests/test_torch_lm.py``)
and ``--xla_backend_optimization_level=0`` (half the compile time, the
same operations; ``tests/test_torch_training.py``).  JAX's ``mla_apply``
runs ``blockwise`` under ``impl="pallas"``; the port's ``"pallas"`` runs
the ``flash_attention`` wrapper (its plain version on the CPU) at qk head
dim 24 with v zero-padded, and is held to JAX's ``blockwise``: the same
function.  MLA decode is the weight-absorbed plain form in both packages
under every impl.

Tolerances, as in ``tests/test_torch_lm.py`` and
``tests/test_torch_jamba.py``: logits within 3e-2 (max abs); bf16
tensors (layer outputs, the latent cache ``ckv`` and rope keys ``kr``)
within two bf16 ulps of the value; the MoE aux loss within 1e-5
relative; the loss within ``LOSS_TOL`` and each gradient leaf within
``GRAD_RTOL`` in relative L2 norm (``tests/test_torch_training.py``).
The serving launcher's control plane (every printed line but the wall
clock) must equal JAX's exactly.  The child runs JAX's launcher
(``repro.launch.serve.main``) on the weights it drew once, so that the
reduced model is initialized once (about 9 s on one core); the control
plane does not depend on the weights (the port's launcher draws its own).
"""

from __future__ import annotations

import contextlib
import functools
import io
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
from repro_torch.configs import get_config as tget_config
from repro_torch.core.tree import key_leaves
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.models import LM as TLM
from repro_torch.models import attention as tattn
from repro_torch.models.model import (
    cache_from_jax,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.serving.engine import _splice_slot
from repro_torch.training.train_step import make_grad_fn

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-v2-lite-16b"
IMPLS = ("blockwise", "reference", "pallas")
LOGIT_TOL = 3e-2
BF16_TOL = dict(rtol=2.0**-6, atol=2.0**-6)
AUX_REL = 1e-5
LOSS_TOL = 2e-3
GRAD_RTOL = 2e-2
B, T, MAX_LEN, STEPS = 2, 16, 32, 3
# The absorbed decode's lengths (the new token included): one inside the
# cache, one past its end (an idle serving slot's), whose row is dropped.
DECODE_LENGTHS = (7, MAX_LEN + 1)
CHILD_FLAGS = ("--xla_allow_excess_precision=false "
               "--xla_backend_optimization_level=0")


def bf16_np(a):
    """f32 numpy values rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float32)


@functools.lru_cache(maxsize=None)
def _data():
    """The numpy inputs both packages share."""
    cfg = jget_config(ARCH).reduced()
    m = cfg.mla
    rng = np.random.default_rng(24)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "steps": rng.integers(0, cfg.vocab_size,
                              (STEPS, B, 1)).astype(np.int32),
        "h": bf16_np(rng.standard_normal((B, T, cfg.d_model))),
        "x1": bf16_np(rng.standard_normal((B, 1, cfg.d_model))),
        "ckv": bf16_np(rng.standard_normal((B, MAX_LEN, m.kv_lora_rank))),
        "kr": bf16_np(rng.standard_normal((B, MAX_LEN,
                                           m.qk_rope_head_dim))),
    }


def mla_kw(cfg) -> dict:
    m = cfg.mla
    return dict(num_heads=cfg.num_heads, kv_lora_rank=m.kv_lora_rank,
                qk_nope_head_dim=m.qk_nope_head_dim,
                qk_rope_head_dim=m.qk_rope_head_dim,
                v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta)


def cache_leaves(cache):
    for si, stage in enumerate(cache["stages"]):
        for lj, layer in stage.items():
            for name, leaf in layer.items():
                yield f"{si}/{lj}/{name}", leaf


def save_params(out: dict, params, prefix: str = "param") -> None:
    """The JAX weights as numpy leaves (bf16 as uint16 bits)."""
    for i, leaf in enumerate(jax.tree.leaves(params)):
        a = np.asarray(leaf)
        out[f"{prefix}/{i}"] = a.view(np.uint16) \
            if a.dtype == jnp.bfloat16 else a


def params_tree(jcfg, refs, prefix: str = "param"):
    """The child's JAX weights, rebuilt as the ``LM.init`` pytree of
    numpy arrays."""
    shapes = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree.flatten(shapes)
    arrays = []
    for i, leaf in enumerate(leaves):
        a = refs[f"{prefix}/{i}"]
        arrays.append(a.view(jnp.bfloat16) if leaf.dtype == jnp.bfloat16
                      else a)
        assert arrays[-1].shape == leaf.shape
    return jax.tree.unflatten(treedef, arrays)


def save_grads(out: dict, prefix: str, grads) -> None:
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    for path, a in flat:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(a, np.float32)


def run_child(tmp_path_factory, module: str) -> dict:
    """``module._write_jax_refs(path)`` in a child process with
    ``CHILD_FLAGS``, and the arrays it saved."""
    path = tmp_path_factory.mktemp("jax_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=CHILD_FLAGS)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            f"import {module} as t; t._write_jax_refs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def jax_launcher_printout(arch: str, params) -> np.ndarray:
    """What JAX's serving launcher prints for the reduced ``arch`` under
    its defaults, run on ``params`` (the child's weights, so that the
    model is not drawn twice), as a numpy string."""
    from repro.launch import serve as jserve

    init = JLM.init
    JLM.init = lambda self, key: params
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jserve.main(["--arch", arch, "--reduced"]) == 0
    finally:
        JLM.init = init
    return np.asarray(buf.getvalue())


def control_plane(text: str) -> list:
    """The launcher's printout, the wall-clock line aside."""
    return [line for line in text.splitlines() if "s wall" not in line]


# ---------------------------------------------------------------------------
# the JAX side, run in a child process that rounds every bf16 op
# ---------------------------------------------------------------------------

def _write_jax_refs(path: str) -> None:
    jcfg, d = jget_config(ARCH).reduced(), _data()
    params = JLM(jcfg).init(jax.random.PRNGKey(0))
    out = {}
    save_params(out, params)
    f32 = lambda a: np.asarray(a, np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tokens = jnp.asarray(d["tokens"])
    for impl in ("blockwise", "reference"):
        logits, aux = jax.jit(JLM(jcfg, attn_impl=impl).forward)(params,
                                                                 tokens)
        out[f"forward/{impl}"], out[f"aux/{impl}"] = f32(logits), f32(aux)
    jm = JLM(jcfg)
    logits, cache = jax.jit(functools.partial(jm.prefill, max_len=MAX_LEN))(
        params, tokens)
    out["prefill/logits"] = f32(logits)
    out["prefill/lengths"] = np.asarray(cache["lengths"])
    for key, leaf in cache_leaves(cache):
        out[f"prefill/{key}"] = f32(leaf)
    step = jax.jit(jm.decode_step)
    prefilled = cache
    for i, tok in enumerate(d["steps"]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        out[f"decode/{i}"] = f32(logits)
    for key, leaf in cache_leaves(cache):
        out[f"decode/{key}"] = f32(leaf)
    out["decode/lengths"] = np.asarray(cache["lengths"])
    cache = dict(prefilled, lengths=jnp.asarray([MAX_LEN, T], jnp.int32))
    for i, tok in enumerate(d["steps"][:2]):
        logits, cache = step(params, cache, jnp.asarray(tok))
        out[f"past_max/{i}"] = f32(logits)
    out["past_max/ckv"] = f32(cache["stages"][0]["l0"]["ckv"])

    # The first layer's mixer alone.
    mixer = jax.tree.map(lambda a: a[0], params["stages"][0]["l0"]["mixer"])
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    for impl in ("blockwise", "reference"):
        y, (ckv, kr) = jattn.mla_apply(
            mixer, bf(d["h"]), **mla_kw(jcfg), positions=pos, causal=True,
            impl=impl, q_block=jcfg.attn_q_block, kv_block=jcfg.attn_kv_block)
        out[f"mla/{impl}/y"], out[f"mla/{impl}/ckv"] = f32(y), f32(ckv)
        out[f"mla/{impl}/kr"] = f32(kr)
    lengths = jnp.asarray(DECODE_LENGTHS, jnp.int32)
    y, ckv, kr = jattn.mla_decode_apply(
        mixer, bf(d["x1"]), bf(d["ckv"]), bf(d["kr"]), lengths,
        **mla_kw(jcfg), positions=(lengths - 1)[:, None])
    out["mla_decode/y"], out["mla_decode/ckv"] = f32(y), f32(ckv)
    out["mla_decode/kr"] = f32(kr)

    batch = {"tokens": tokens, "labels": tokens}
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    out["loss"] = f32(loss)
    save_grads(out, "grads", grads)
    out["serve"] = jax_launcher_printout(ARCH, params)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return run_child(tmp_path_factory, "test_torch_mla")


@pytest.fixture(scope="module")
def setup(refs):
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    assert [s.mixer for p, r in tcfg.stages() for _ in range(r)
            for s in p] == ["mla"] * 3
    tree = params_tree(jcfg, refs)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree,
                state=params_from_jax(tcfg, tree), data=_data())


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


def check_logits(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= LOGIT_TOL, f"{what}: max abs error {err}"


def check_bf16(got, want, what):
    assert got.dtype == torch.bfloat16, what
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(_np(got), want, err_msg=what, **BF16_TOL)


def check_cache(cache, refs, prefix):
    got = dict(cache_leaves(cache))
    keys = [k for k in refs if k.startswith(prefix + "/")
            and k.count("/") == prefix.count("/") + 3]
    assert sorted(f"{prefix}/{k}" for k in got) == sorted(keys)
    for key, leaf in got.items():
        check_bf16(leaf, refs[f"{prefix}/{key}"], key)


def jax_cache(refs, prefix, lengths=None) -> dict:
    """The port's copy of a JAX cache saved under ``prefix``."""
    stages: list = []
    for key in sorted(k for k in refs if k.startswith(prefix + "/")
                      and k.count("/") == prefix.count("/") + 3):
        si, lj, name = key[len(prefix) + 1:].split("/")
        while len(stages) <= int(si):
            stages.append({})
        stages[int(si)].setdefault(lj, {})[name] = _t(refs[key])
    lens = refs[f"{prefix}/lengths"] if lengths is None else lengths
    return {"stages": stages,
            "lengths": torch.tensor(lens, dtype=torch.int32)}


def hold_grads(got: dict, refs, prefix: str, like) -> None:
    """Each gradient leaf within ``GRAD_RTOL`` of JAX's in relative L2
    norm, with the leaf's dtype."""
    assert sorted(got) == sorted(k[len(prefix):] for k in refs
                                 if k.startswith(prefix + "["))
    for path, leaf in key_leaves(like):
        assert got[path].dtype == leaf.dtype, path
        want = torch.from_numpy(refs[prefix + path].copy())
        den = float(want.norm())
        assert den > 0, path
        rel = float((got[path].float() - want).norm()) / den
        assert rel <= GRAD_RTOL, (path, rel)


# ---------------------------------------------------------------------------
# weights and caches carried across
# ---------------------------------------------------------------------------

def test_params_round_trip(setup):
    tcfg, tree, state = setup["tcfg"], setup["tree"], setup["state"]
    model = _tmodel(setup)
    mixer = model.layers[0].mixer
    assert mixer["kv_norm"]["scale"].dtype == torch.float32
    assert tuple(mixer["wq"].shape) == (64, 4 * 24)
    back = params_to_numpy(tcfg, state)

    def same(a, b):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)

    jax.tree.map(same, tree, back)
    # a model drawn by the port's own init has JAX's leaves and kv_norm 1
    own = TLM(tcfg, device="cpu").init(3)
    assert own.state_dict().keys() == state.keys()
    assert bool((own.layers[1].mixer["kv_norm"]["scale"] == 1).all())


def test_cache_from_jax_carries_the_latents(setup, refs):
    cache = {"stages": [], "lengths": refs["prefill/lengths"]}
    for key in sorted(k for k in refs if k.startswith("prefill/")
                      and k.count("/") == 3):
        si, lj, name = key.split("/")[1:]
        while len(cache["stages"]) <= int(si):
            cache["stages"].append({})
        bits = np.asarray(jnp.asarray(refs[key]).astype(jnp.bfloat16))
        cache["stages"][int(si)].setdefault(lj, {})[name] = bits
    got = cache_from_jax(cache)
    assert sorted(got["stages"][1]["l0"]) == ["ckv", "kr"]
    for si, stage in enumerate(cache["stages"]):
        for name, a in stage["l0"].items():
            t = got["stages"][si]["l0"][name]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
    # layers x batch x max_len x (kv_lora_rank | rope dim)
    assert tuple(got["stages"][1]["l0"]["ckv"].shape) == (2, B, MAX_LEN, 32)
    assert tuple(got["stages"][1]["l0"]["kr"].shape) == (2, B, MAX_LEN, 8)


# ---------------------------------------------------------------------------
# the MLA mixer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_mla_apply_matches_jax(setup, refs, impl):
    """The full-sequence form on layer 0's weights; ``pallas`` against
    JAX's ``blockwise`` (its ``mla_apply`` runs that under ``pallas``)."""
    cfg, d = setup["tcfg"], setup["data"]
    mixer = _tmodel(setup).layers[0].mixer
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    y, (ckv, kr) = tattn.mla_apply(
        mixer, _t(d["h"]), **mla_kw(cfg), positions=pos, causal=True,
        impl=impl, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    want = "reference" if impl == "reference" else "blockwise"
    check_bf16(y, refs[f"mla/{want}/y"], f"{impl} y")
    check_bf16(ckv, refs[f"mla/{want}/ckv"], f"{impl} ckv")
    check_bf16(kr, refs[f"mla/{want}/kr"], f"{impl} kr")


def test_mla_prefill_sends_the_192_wide_heads_to_flash(setup, monkeypatch):
    """Under ``pallas`` MLA prefill calls ``flash_attention`` with q, k
    and v at the qk head dim ``dn + dr``: dense operands, H = KV, v's
    tail zero."""
    cfg, d = setup["tcfg"], setup["data"]
    seen = []
    flash = kops.flash_attention

    def record(q, k, v, *, causal):
        seen.append((q, k, v, causal))
        return flash(q, k, v, causal=causal)

    monkeypatch.setattr(kops, "flash_attention", record)
    mixer = _tmodel(setup).layers[0].mixer
    tattn.mla_apply(mixer, _t(d["h"]), **mla_kw(cfg),
                    positions=torch.arange(T)[None].expand(B, T),
                    impl="pallas")
    [(q, k, v, causal)] = seen
    m = cfg.mla
    D = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert causal and tuple(q.shape) == tuple(k.shape) == tuple(v.shape) \
        == (B, T, cfg.num_heads, D)
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    assert bool((v[..., m.v_head_dim:] == 0).all())
    # every head's rope half is the one shared rope key
    assert bool((k[:, :, :, m.qk_nope_head_dim:]
                 == k[:, :, :1, m.qk_nope_head_dim:]).all())


def test_mla_decode_apply_matches_jax(setup, refs):
    """The absorbed decode from a random latent cache; slot 1's length is
    past ``max_len``, so its new row is dropped (JAX's ``.at[].set``)."""
    cfg, d = setup["tcfg"], setup["data"]
    mixer = _tmodel(setup).layers[0].mixer
    ckv, kr = _t(d["ckv"]), _t(d["kr"])
    before = ckv.clone()
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32)
    y, ckv2, kr2 = tattn.mla_decode_apply(
        mixer, _t(d["x1"]), ckv, kr, lengths, **mla_kw(cfg),
        positions=(lengths - 1)[:, None])
    assert ckv2 is ckv and kr2 is kr                 # written in place
    check_bf16(y, refs["mla_decode/y"], "y")
    check_bf16(ckv, refs["mla_decode/ckv"], "ckv")
    check_bf16(kr, refs["mla_decode/kr"], "kr")
    assert torch.equal(ckv[1], before[1])            # past the end: dropped
    assert not torch.equal(ckv[0, DECODE_LENGTHS[0] - 1],
                           before[0, DECODE_LENGTHS[0] - 1])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(setup, refs, impl):
    want = "reference" if impl == "reference" else "blockwise"
    got, aux = _tmodel(setup, impl).forward(
        torch.from_numpy(setup["data"]["tokens"]))
    check_logits(got, refs[f"forward/{want}"], f"forward/{impl}")
    ref_aux = float(refs[f"aux/{want}"])
    assert ref_aux > 0
    assert abs(float(aux) - ref_aux) <= AUX_REL * ref_aux, (float(aux),
                                                            ref_aux)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(setup, refs, impl):
    logits, cache = _tmodel(setup, impl).prefill(
        torch.from_numpy(setup["data"]["tokens"]), max_len=MAX_LEN)
    check_logits(logits, refs["prefill/logits"], f"prefill/{impl}")
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs["prefill/lengths"])
    check_cache(cache, refs, "prefill")


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_jax(setup, refs, impl):
    """Three decode steps from JAX's prefilled cache (every impl decodes
    with the absorbed plain MLA, as JAX's LM does)."""
    tm = _tmodel(setup, impl)
    cache = jax_cache(refs, "prefill")
    for i, tok in enumerate(setup["data"]["steps"]):
        got, cache = tm.decode_step(cache, torch.from_numpy(tok))
        check_logits(got, refs[f"decode/{i}"], f"decode/{impl} step {i}")
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  refs["decode/lengths"])
    check_cache(cache, refs, "decode")


def test_decode_drives_a_slot_past_max_len(setup, refs):
    cache = jax_cache(refs, "prefill", lengths=[MAX_LEN, T])
    before = cache["stages"][0]["l0"]["ckv"].clone()
    tm = _tmodel(setup)
    for i, tok in enumerate(setup["data"]["steps"][:2]):
        got, cache = tm.decode_step(cache, torch.from_numpy(tok))
        check_logits(got, refs[f"past_max/{i}"], "decode past max_len")
    assert cache["lengths"].tolist() == [MAX_LEN + 2, T + 2]
    after = cache["stages"][0]["l0"]["ckv"]
    assert torch.equal(after[:, 0], before[:, 0])    # slot 0: no write
    check_bf16(after, refs["past_max/ckv"], "ckv")


def test_loss_and_gradients_match_jax(setup, refs):
    tm = _tmodel(setup)
    params = tm.stacked_params()
    tokens = torch.from_numpy(setup["data"]["tokens"])
    batch = {"tokens": tokens, "labels": tokens}
    loss = tm.loss(batch, params=params)
    assert abs(float(loss) - float(refs["loss"])) <= LOSS_TOL
    loss2, grads = make_grad_fn(tm, remat=False)(params, batch)
    assert float(loss2) == float(loss)
    hold_grads(dict(key_leaves(grads)), refs, "grads", params)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_splice_slot_moves_the_latent_leaves(setup):
    tm = _tmodel(setup)
    big = tm.init_cache(3, MAX_LEN)
    _, one = tm.prefill(torch.from_numpy(setup["data"]["tokens"][:1]),
                        max_len=MAX_LEN)
    _splice_slot(big, one, 2)
    for (_, got), (_, want) in zip(cache_leaves(big), cache_leaves(one)):
        assert torch.equal(got[:, 2], want[:, 0])
        assert not bool(got[:, :2].any())


def test_serve_launcher_matches_jax(refs, capsys):
    """``--arch deepseek-v2-lite-16b --reduced`` under the launcher's
    defaults (6 requests of 12 tokens, 4 slots): the same control plane
    as JAX's launcher, line for line."""
    assert tserve.main(["--arch", ARCH, "--reduced", "--device",
                        "cpu"]) == 0
    printed = capsys.readouterr().out
    assert printed.startswith("served 6/6 requests")
    assert control_plane(printed) == control_plane(str(refs["serve"]))
