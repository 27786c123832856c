"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA) d_ff=5120
vocab=504.  Encoder-only transformer backbone (w2v2 arch); the conv
feature extractor is a STUB per the brief — input_specs() supplies
precomputed frame embeddings [B, T, 1280].  [arXiv:2106.07447]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,        # k-means cluster targets
    causal=False,          # encoder-only, bidirectional
    activation="gelu",
    norm="layernorm",
    rope_theta=10000.0,
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=False,  # no decode shapes for encoder-only
    subquadratic=False,
    input_mode="embeds",
    notes="encoder-only: decode_32k and long_500k SKIPPED per brief;"
          " train = masked-frame cluster prediction.",
))
