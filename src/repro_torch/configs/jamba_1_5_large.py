"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2.  Mamba+attention 1:7 interleave,
MoE every other layer.  [arXiv:2403.19887; hf]

Layer layout: blocks of 8 = [attn] + 7×[mamba], MoE on every other
layer (4 MoE per block); 9 blocks -> 72 layers.  One lax.scan over the
9 stacked super-blocks.
"""

from repro_torch.configs.base import (
    ArchConfig, LayerSpec, MambaSpec, MoESpec, register_config,
)

_BLOCK = (
    LayerSpec("gqa", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
)

CONFIG = register_config(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2, chunk=128),
    block_pattern=_BLOCK,
    supports_decode=True,
    subquadratic=True,   # attention only every 8th layer; 500k runs
    notes="hybrid: KV cache only for the 9 attention layers; mamba state"
          " is O(1) in seq len, so long_500k RUNS for this arch.",
))
