"""Core engine of the PyTorch port: events, codec, queue, composer,
engine and program (see :mod:`repro_torch.api` for the public surface)."""
