"""The CUDA attention wrappers' checks, which run on the host before any
launch: every call that the kernels cannot take raises, on the CPU too
(the wrappers build and load nothing before their checks pass), and a
call signature that passed is remembered with its launch arguments."""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash


def _flash_inputs(D=64, dtype=torch.bfloat16, T=8, H=4, KV=2):
    q = torch.zeros((1, T, H, D), dtype=dtype).transpose(1, 2)
    k = torch.zeros((1, T, KV, D), dtype=dtype).transpose(1, 2)
    return q, k, k


@pytest.mark.parametrize("D", [16, 48, 96, 256])
def test_bf16_flash_takes_only_the_wgmma_head_dims(D):
    """The wgmma kernel is instantiated at every multiple of 16 up to 256
    (``tests/test_torch_flash_head_dims.py`` plans a bf16 launch at each);
    the wrapper refuses a bf16 call at a head dim between them before
    any build."""
    q, k, v = _flash_inputs(D + 8)
    with pytest.raises(ValueError, match="multiple of 16"):
        tflash.flash_attention_cuda(q, k, v)


def test_flash_rejects_rows_off_16_bytes():
    base = torch.zeros((1, 8, 4, 68), dtype=torch.bfloat16)
    q = base[..., :64].transpose(1, 2)          # rows 136 bytes apart
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tflash.flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("bad", ["dtype", "shape", "last_dim", "heads"])
def test_flash_keeps_its_operand_checks(bad):
    q, k, v = _flash_inputs()
    if bad == "dtype":
        k = k.float()
    elif bad == "shape":
        v = v[:, :, :4]
    elif bad == "last_dim":
        q = torch.zeros((1, 4, 64, 8), dtype=torch.bfloat16).transpose(2, 3)
    else:
        q = torch.zeros((1, 3, 8, 64), dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        tflash.flash_attention_cuda(q, k, v)


def _decode_inputs(D=64, S=96, dtype=torch.bfloat16):
    q = torch.zeros((2, 4, D), dtype=dtype)
    kc = torch.zeros((2, S, 2, D), dtype=dtype).transpose(1, 2)
    return q, kc, kc, torch.tensor([3, S], dtype=torch.int32)


@pytest.mark.parametrize("bad", ["lengths_dtype", "lengths_shape",
                                 "cache_shape", "cache_rows", "head_dim"])
def test_decode_keeps_its_checks(bad):
    q, kc, vc, lens = _decode_inputs()
    if bad == "lengths_dtype":
        lens = lens.long()
    elif bad == "lengths_shape":
        lens = lens[:1]
    elif bad == "cache_shape":
        vc = vc[:, :, :50]
    elif bad == "cache_rows":
        base = torch.zeros((2, 96, 2, 68), dtype=torch.bfloat16)
        kc = base[..., :64].transpose(1, 2)
    else:
        q, kc, vc, lens = _decode_inputs(D=40)
    with pytest.raises((TypeError, ValueError)):
        tdecode.decode_attention_cuda(q, kc, vc, lens)


def test_signature_tells_layouts_apart():
    q, k, v = _flash_inputs()
    same = _build.signature(q, k, v)
    assert _build.signature(q, k, v) == same
    assert _build.signature(q.contiguous(), k, v) != same
    assert _build.signature(q.float(), k, v) != same


def test_remember_bounds_the_plan_cache(monkeypatch):
    monkeypatch.setattr(_build, "PLANS", {})
    monkeypatch.setattr(_build, "MAX_PLANS", 3)
    for i in range(7):
        assert _build.remember(("key", i), i) == i
        assert len(_build.PLANS) <= 3
    assert _build.PLANS[("key", 6)] == 6

