"""KV caches for decode (PyTorch port of :mod:`repro.models.kvcache`).

Leaves are stacked over the layer axis, as in the JAX package, so the
cache keeps its layout and the serving engine's slot splice ports
directly:

* GQA:   k/v  [L, B, S, KV, D]
* MLA:   ckv [L, B, S, R] and kr [L, B, S, dr] (the compressed latents
  and the rotated rope key, in the activation dtype)
* Mamba: h [L, B, I, N] f32 (the SSM state) and conv [L, B, K-1, I]
  (the conv's last inputs, in the activation dtype).
* RWKV6: x_att [L, B, 1, D] (the time-mix's last input token) and
  S [L, B, H, K, K] f32 (the WKV state); the channel-mix's x_ffn
  [L, B, 1, D] is added by ``LM.init_cache``.

``lengths: i32[B]`` (kept beside the stages by ``LM.init_cache``) counts
valid tokens per sequence, shared across layers.
"""

from __future__ import annotations

import torch


def gqa_cache_init(num_layers, batch, max_len, num_kv_heads, head_dim,
                   dtype=torch.bfloat16, device=None):
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def mla_cache_init(num_layers, batch, max_len, kv_lora_rank, rope_dim,
                   dtype=torch.bfloat16, device=None):
    return {
        "ckv": torch.zeros((num_layers, batch, max_len, kv_lora_rank),
                           dtype=dtype, device=device),
        "kr": torch.zeros((num_layers, batch, max_len, rope_dim),
                          dtype=dtype, device=device),
    }


def mamba_cache_init(num_layers, batch, d_inner, d_state, d_conv,
                     conv_dtype=torch.bfloat16, device=None):
    return {
        "h": torch.zeros((num_layers, batch, d_inner, d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((num_layers, batch, d_conv - 1, d_inner),
                            dtype=conv_dtype, device=device),
    }


def rwkv_cache_init(num_layers, batch, d_model, head_dim,
                    dtype=torch.bfloat16, device=None):
    H = d_model // head_dim
    return {
        "x_att": torch.zeros((num_layers, batch, 1, d_model), dtype=dtype,
                             device=device),
        "S": torch.zeros((num_layers, batch, H, head_dim, head_dim),
                         dtype=torch.float32, device=device),
    }
