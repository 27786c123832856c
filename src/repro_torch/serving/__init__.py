"""Serving of the PyTorch port: the DES-driven continuous-batching
engine (:mod:`repro_torch.serving.engine`)."""
