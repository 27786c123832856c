"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408
vocab=102400, MoE 64e top-6, MLA kv_lora=512, 2 shared experts.
[arXiv:2405.04434; hf]

Note: the assignment line lists both "MoE 64e top-6" and "2 shared+160
routed"; 160 routed is the *full* DeepSeek-V2.  The Lite model (which
the 16B size and kv_lora=512 identify) has 64 routed + 2 shared, top-6,
expert d_ff 1408, first layer dense (d_ff 10944) — we implement Lite.
MLA: qk_nope 128, qk_rope 64, v 128, no q-LoRA.
"""

from repro_torch.configs.base import (
    ArchConfig, LayerSpec, MLASpec, MoESpec, register_config,
)

CONFIG = register_config(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,   # the single dense first layer
    vocab_size=102400,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoESpec(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    mla=MLASpec(kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128),
    first_layer_pattern=(LayerSpec("mla", "mlp"),),
    block_pattern=(LayerSpec("mla", "moe"),),
    supports_decode=True,
    subquadratic=False,
    notes="MLA: decode cache stores (512 latent + 64 rope) per token —"
          " weight-absorbed decode in models/attention.py;"
          " long_500k skipped (full attention).",
))
