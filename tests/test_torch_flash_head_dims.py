"""bf16 ``flash_attention`` at every head dim, and hubert-xlarge's 80.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there at every multiple of 16 from 16 to 256,
and at hubert-xlarge's layout).  Here:

* the wrapper's routes: every head dim a ``repro_torch.configs`` entry
  sends to flash, and every multiple of 16 in [16, 256], reaches a bf16
  launch plan (all checks, shared memory included) without a refusal;
* ``flash_attention_plain`` at hubert's layout (H 16, KV 16, D 80,
  bidirectional) against JAX's ``flash_attention_pallas`` in interpret
  mode, on the same numpy inputs.  Tolerance 1e-5 (max abs, f32): both
  sum the same f32 products, the Pallas kernel with an online softmax;
* a two-layer hubert-shaped ``LM`` (head dim 80, d_model 160, 2 heads,
  layernorm, gelu, bidirectional) from ONE set of JAX weights
  (``params_from_jax``) against ``repro``'s ``LM.forward``.  The JAX side
  runs in a child process with ``--xla_allow_excess_precision=false``,
  as in ``test_torch_lm.py``.  Tolerance: logits within 3e-2 (max abs),
  as there: a bf16 activation may still round to the neighbouring value
  in one package and not the other.
"""

from __future__ import annotations

import dataclasses
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
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import LM as JLM
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_configs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import LM as TLM
from repro_torch.models.model import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PLAIN_TOL = 1e-5
LOGIT_TOL = 3e-2
B, T = 2, 32


def _flash_head_dims() -> dict:
    """Config name -> head dim, for every config with attention layers
    that go to ``flash_attention`` (``gqa`` mixers)."""
    out = {}
    for name in list_configs():
        cfg = tget_config(name)
        mixers = {spec.mixer for pattern, _ in cfg.stages()
                  for spec in pattern}
        if "gqa" in mixers:
            out[name] = cfg.resolved_head_dim
    return out


FLASH_HEAD_DIMS = _flash_head_dims()


class _SmemOnly:
    """The one library call a launch plan makes: the shared memory a
    launch needs (attention.cu: Q, then two stages of K and V, bf16)."""

    @staticmethod
    def flash_attention_smem_bytes(code, D):
        assert code == 1
        return 2 * D * (128 + 4 * 64)

    flash_attention_launch = None


def _plan(D: int, monkeypatch):
    monkeypatch.setattr(tflash, "_lib", lambda: _SmemOnly)
    q = torch.zeros((1, 8, 16, D), dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros((1, 8, 16, D), dtype=torch.bfloat16).transpose(1, 2)
    return tflash._flash_plan(q, k, k)


def test_configs_cover_the_serving_head_dims():
    assert FLASH_HEAD_DIMS["hubert-xlarge"] == 80
    assert FLASH_HEAD_DIMS["stablelm-12b"] == 160
    assert {64, 80, 128, 160} <= set(FLASH_HEAD_DIMS.values())


@pytest.mark.parametrize("name", sorted(FLASH_HEAD_DIMS))
def test_every_config_head_dim_has_a_bf16_route(name, monkeypatch):
    D = FLASH_HEAD_DIMS[name]
    assert tflash.flash_route(torch.bfloat16, D) == "wgmma"
    _, code, dims, _, scale = _plan(D, monkeypatch)
    assert (code, dims[-1]) == (1, D)
    assert scale == pytest.approx(D ** -0.5)


@pytest.mark.parametrize("D", range(16, 257, 16))
def test_every_multiple_of_16_has_a_bf16_route(D, monkeypatch):
    assert tflash.flash_route(torch.bfloat16, D) == "wgmma"
    _, code, dims, _, _ = _plan(D, monkeypatch)
    assert (code, dims[-1]) == (1, D)
    assert _SmemOnly.flash_attention_smem_bytes(1, D) <= tflash.SMEM_LIMIT


@pytest.mark.parametrize("D", [8, 40, 264])
def test_head_dims_off_the_grid_are_refused(D):
    with pytest.raises(ValueError, match="multiple of 16"):
        tflash.flash_route(torch.bfloat16, D)


@pytest.mark.parametrize("T", [32, 256])
def test_plain_matches_pallas_at_hubert_layout(T):
    """H 16, KV 16, D 80, bidirectional: the port's wrapper on CPU
    tensors (its plain version) against the Pallas kernel."""
    rng = np.random.default_rng(T)
    q, k, v = (rng.standard_normal((1, 16, T, 80)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        interpret=True))
    before = tflash.LAUNCHES["flash_attention"]
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=False)
    assert tflash.LAUNCHES["flash_attention"] == before   # the plain route
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PLAIN_TOL)


# ---------------------------------------------------------------------------
# a two-layer hubert-shaped LM, JAX against the port
# ---------------------------------------------------------------------------

NARROW = dict(d_model=160, num_heads=2, num_kv_heads=2, head_dim=80,
              d_ff=320)
IMPLS = ("blockwise", "pallas")


def _inputs():
    jcfg = dataclasses.replace(jget_config("hubert-xlarge").reduced(),
                               **NARROW)
    params = JLM(jcfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(16).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    return jcfg, params, tokens


def _write_jax_refs(path: str) -> None:
    jcfg, params, tokens = _inputs()
    out = {"embed_sum": np.asarray(params["embed"], np.float32).sum()}
    for impl in IMPLS:
        jm = JLM(jcfg, attn_impl=impl)
        out[impl] = np.asarray(jax.jit(jm.forward)(
            params, jnp.asarray(tokens))[0], np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_flash_head_dims as t; "
            "t._write_jax_refs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("impl", IMPLS)
def test_hubert_shaped_lm_matches_jax(refs, impl):
    jcfg, params, tokens = _inputs()
    tcfg = dataclasses.replace(tget_config("hubert-xlarge").reduced(),
                               **NARROW)
    assert (tcfg.num_layers, tcfg.resolved_head_dim, tcfg.causal,
            tcfg.norm, tcfg.activation) == (2, 80, False, "layernorm",
                                            "gelu")
    assert np.asarray(params["embed"], np.float32).sum() == refs["embed_sum"]
    model = TLM(tcfg, attn_impl=impl, device="cpu")
    model.load_state_dict(params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             params)))
    got, _ = model.forward(torch.from_numpy(tokens))
    V = tcfg.vocab_size
    assert got.shape == refs[impl].shape
    got, want = got.numpy()[..., :V], refs[impl][..., :V]
    err = np.max(np.abs(got - want))
    assert err <= LOGIT_TOL, f"{impl}: max abs error {err}"
    # Greedy choices agree wherever JAX's top-1/top-2 margin exceeds 0.1,
    # and most rows clear it.
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 0.1
    assert clear.sum() >= clear.size // 2
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])
