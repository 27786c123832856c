"""Deterministic synthetic data (PyTorch port of :mod:`repro.data`)."""
