"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536.  Finch: data-dependent decay.  [arXiv:2404.05892]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # 2048 / 64 time-mix heads
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    activation="sqrelu",   # channel-mix uses squared relu
    norm="layernorm",
    rwkv_head_dim=64,
    rwkv_chunk=32,   # pairwise-exact intra-chunk decay: [L,L,K] per chunk
    block_pattern=(LayerSpec("rwkv", "rwkv_cm"),),
    supports_decode=True,
    subquadratic=True,     # linear attention: long_500k RUNS
    notes="attention-free; decode state is (H,64,64) per layer —"
          " long_500k decode is O(1) per token.",
))
