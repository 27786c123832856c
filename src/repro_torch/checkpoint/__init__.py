"""Checkpointing for the PyTorch port: see
:mod:`repro_torch.checkpoint.manager`."""
