"""Serving of the PyTorch port: the DES-driven continuous-batching
engine (:mod:`repro_torch.serving.engine`) and its simulation twin, the
admission scenario (:mod:`repro_torch.serving.scenarios`)."""
