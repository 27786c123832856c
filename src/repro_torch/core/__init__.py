"""Core engine of the PyTorch port: events, codec, queue, composer,
engine, sharded engine, program and the host-side window extraction
(scheduler); see :mod:`repro_torch.api` for the public surface."""

from repro_torch.core.sharded import ShardedDeviceEngine, ShardedQueue

__all__ = ["ShardedDeviceEngine", "ShardedQueue"]
