"""Training: AdamW, gradient compression and the train step (PyTorch port
of :mod:`repro.training`)."""
