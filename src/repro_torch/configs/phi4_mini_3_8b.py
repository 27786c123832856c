"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064.  RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=True,
    subquadratic=False,
    notes="200k vocab stresses the vocab-sharded embed/unembed path;"
          " long_500k skipped (full attention).",
))
