"""LM stack of the PyTorch port (GQA + MLP stages)."""

from repro_torch.models.model import LM

__all__ = ["LM"]
