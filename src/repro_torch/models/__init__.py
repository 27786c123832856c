"""LM stack of the PyTorch port ((gqa, mlp) and (rwkv, rwkv_cm) stages)."""

from repro_torch.models.model import LM

__all__ = ["LM"]
