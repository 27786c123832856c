"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36, i.e. MHA)
d_ff=5760 vocab=122753.  WSD schedule (arch llama-like).
[arXiv:2404.06395; hf]"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register_config

CONFIG = register_config(ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    block_pattern=(LayerSpec("gqa", "mlp"),),
    supports_decode=True,
    subquadratic=False,
    notes="trained with the WSD schedule (training/optim.py wsd_schedule);"
          " long_500k skipped (full attention).",
))
