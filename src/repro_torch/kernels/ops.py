"""Model-layout entry points of the attention kernels.

Counterpart of :mod:`repro.kernels.ops`.  The models keep ``[B, T, H,
D]``; the kernels' contract is ``[B, H, T, D]``.  JAX transposes into
the kernel layout first; here the transposes are views that the CUDA
kernels read through their strides, so nothing is copied.  The
``rwkv6_scan`` and ``mamba_scan`` entry points come with their kernels.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128):
    """q: [B,T,H,D]; k/v: [B,S,KV,D] (model layout) -> [B,T,H,D]."""
    o = _flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               block_q=block_q)
    return o.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; caches: [B,S,KV,D] (model layout) -> [B,H,D]."""
    return _decode.decode_attention(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), lengths)
