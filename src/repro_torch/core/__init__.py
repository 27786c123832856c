"""Core engine of the PyTorch port: events, codec, queue, composer,
engine, program and the host-side window extraction (scheduler); see
:mod:`repro_torch.api` for the public surface."""
