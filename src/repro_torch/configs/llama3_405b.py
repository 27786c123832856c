"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  GQA, 128k vocab.  [arXiv:2407.21783]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=500000.0,
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=True,
    subquadratic=False,
    notes="largest dense cell; long_500k skipped (full attention).",
))
