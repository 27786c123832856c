"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b family; hf]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=True,
    subquadratic=False,
    notes="dense GQA decoder; long_500k skipped (full attention).",
))
