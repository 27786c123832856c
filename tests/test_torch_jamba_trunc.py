"""The port's LM against the JAX package's on the two-layer jamba
truncation ``[(gqa, mlp), (mamba, moe)]`` that ``chip_smoke.py`` serves
at full width (here at the reduced widths).

The configuration, the JAX child process, the inputs and the tolerances
are those of ``tests/test_torch_jamba.py``, whose helpers run here (one
file a configuration keeps each JAX child well under a minute).  The
kernel route's decode is held to JAX's decode with the Pallas decode
kernel.  The mamba block itself is held to JAX's on layer 1's weights:
``mamba_apply`` under the three impls, from a zero state and (the plain
impls) from a given ``(h0, conv0)``, and ``mamba_decode_step``.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.models import ssm as tssm
from test_torch_jamba import (
    B,
    IMPLS,
    T_LAYER,
    _check_bf16,
    _check_f32,
    _t,
    _tmodel,
    check_decode,
    check_forward,
    check_prefill,
    gaps,  # noqa: F401  (a fixture)
    jax_refs,
    make_setup,
)

CASES = ("trunc",)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return jax_refs(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def setup(refs):
    return make_setup(refs)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_forward(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_prefill(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_jax(setup, refs, gaps, case, impl):  # noqa: F811
    check_decode(setup, refs, gaps, case, impl)


@pytest.mark.parametrize("impl,case", [
    ("blockwise", "zero"), ("blockwise", "state"), ("reference", "zero"),
    ("reference", "state"), ("pallas", "zero")])
def test_mamba_apply_matches_jax(setup, refs, impl, case):
    """T = 13 with chunk 8: a padded last chunk for the chunked form.
    The kernel route starts from a zero state (see
    ``test_pallas_route_refuses_h0``); conv0 alone it takes."""
    s = setup("trunc")
    cfg, d = s["tcfg"], s["data"]
    mm = cfg.mamba
    mixer = _tmodel(s).layers[1].mixer
    kw = {}
    if case == "state":
        kw = {"h0": torch.from_numpy(d["h0"].copy()),
              "conv0": _t(d["conv0"])}
    y, (h, conv) = tssm.mamba_apply(
        mixer, _t(d["x"]), d_state=mm.d_state, d_conv=mm.d_conv,
        chunk=mm.chunk, return_state=True, impl=impl, **kw)
    assert y.shape == (B, T_LAYER, cfg.d_model)
    _check_bf16(y, refs[f"mamba/{case}/y"], "y")
    _check_bf16(conv, refs[f"mamba/{case}/conv"], "conv tail")
    _check_f32(h, refs[f"mamba/{case}/h"], "h")


def test_pallas_route_refuses_h0(setup):
    s = setup("trunc")
    mixer = _tmodel(s).layers[1].mixer
    with pytest.raises(ValueError, match="h0"):
        tssm.mamba_apply(mixer, _t(s["data"]["x"]), d_state=4,
                         h0=torch.from_numpy(s["data"]["h0"].copy()),
                         impl="pallas")


def test_mamba_decode_step_matches_jax(setup, refs):
    s = setup("trunc")
    cfg, d = s["tcfg"], s["data"]
    mixer = _tmodel(s).layers[1].mixer
    state = {"h": torch.from_numpy(d["h0"].copy()), "conv": _t(d["conv0"])}
    y, st = tssm.mamba_decode_step(mixer, _t(d["x1"]),
                                   state, d_state=cfg.mamba.d_state,
                                   d_conv=cfg.mamba.d_conv)
    _check_bf16(y, refs["mamba/one/y"], "y")
    _check_bf16(st["conv"], refs["mamba/one/conv"], "conv")
    _check_f32(st["h"], refs["mamba/one/h"], "h")
    assert torch.equal(state["h"], torch.from_numpy(d["h0"]))  # not in place
    zero = tssm.mamba_state_init(B, d_model=cfg.d_model,
                                 d_state=cfg.mamba.d_state,
                                 d_conv=cfg.mamba.d_conv)
    assert {k: (tuple(v.shape), v.dtype) for k, v in zero.items()} == {
        "h": (tuple(state["h"].shape), torch.float32),
        "conv": (tuple(state["conv"].shape), torch.bfloat16)}
    assert not any(bool(v.any()) for v in zero.values())
