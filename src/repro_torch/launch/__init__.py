"""Entry points of the PyTorch port (:mod:`repro_torch.launch.serve`)."""
