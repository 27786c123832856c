"""Model-facing entry points of the kernels.

Counterpart of :mod:`repro.kernels.ops`.  The models keep ``[B, T, H,
D]``; the attention kernels' contract is ``[B, H, T, D]``.  JAX
transposes into the kernel layout first; here the transposes are views
that the CUDA kernels read through their strides, so nothing is copied.
``rwkv6_scan`` takes the kernel layout ``[B, H, T, K]`` as JAX's does;
the model hands it strided views.  ``mamba_scan`` takes ``[B, T, I]`` and
``[B, T, N]`` as JAX's does; the model hands it ``B_t``/``C_t`` as column
slices of its ``x_proj`` output.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import rwkv6_scan as _rwkv


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


def rwkv6_scan(r, k, v, logw, u, *, chunk: int = 64,
               return_state: bool = False):
    """r/k/v/logw: [B,H,T,K] (strided views welcome); u: [H,K] ->
    y [B,H,T,K] f32, and with ``return_state`` also S_T [B,H,K,K] f32.

    ``chunk`` is the Pallas kernel's sequence tile; it is kept so that
    both packages take the same call.  The CUDA kernel walks the tokens
    itself and needs no chunk and no padding.
    """
    del chunk
    y, s_final = _rwkv.rwkv6_scan(r, k, v, logw, u)
    return (y, s_final) if return_state else y


def mamba_scan(xdt, dt, bc, cc, a, *, chunk: int = 32, block_i: int = 256,
               return_state: bool = False):
    """Selective scan: xdt/dt [B,T,I]; bc/cc [B,T,N] (strided views
    welcome); a [I,N] -> y [B,T,I] f32, and with ``return_state`` also
    h_T [B,I,N] f32.

    ``chunk`` and ``block_i`` are the Pallas kernel's sequence and channel
    tiles; they are kept so that both packages take the same call.  The
    CUDA kernel walks the tokens itself, one thread a channel, and needs
    neither and no padding.
    """
    del chunk, block_i
    y, h_final = _mamba.mamba_scan(xdt, dt, bc, cc, a)
    return (y, h_final) if return_state else y
