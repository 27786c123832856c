"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register_config

CONFIG = register_config(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    moe=MoESpec(num_experts=32, top_k=8, d_ff_expert=512),
    block_pattern=(LayerSpec("gqa", "moe"),),
    supports_decode=True,
    subquadratic=False,
    notes="every layer MoE, 32 experts top-8; long_500k skipped"
          " (full attention).",
))
