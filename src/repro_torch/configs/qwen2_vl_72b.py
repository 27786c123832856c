"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

The vision tower is a STUB per the brief: input_specs() provides
precomputed patch embeddings [B, T, 8192] plus the (3, B, T) M-RoPE
position grid (temporal/height/width).  Decode operates on text tokens.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    m_rope=True,
    m_rope_sections=(16, 24, 24),   # pairs per t/h/w section of 128-dim head
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=True,
    subquadratic=False,
    input_mode="embeds",
    notes="M-RoPE positions are a (3,B,T) grid; prefill takes patch"
          " embeddings, decode takes text tokens; long_500k skipped.",
))
