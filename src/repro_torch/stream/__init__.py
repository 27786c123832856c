"""Open-system ingestion for the PyTorch port: host-to-device arrival
streams (DESIGN.md §10).

An :class:`~repro_torch.stream.source.ArrivalSource` produces fixed-size
arrival blocks in the emit-row layout, and
:class:`~repro_torch.stream.ingest.StreamFeeder` stages them for the
device while the engine runs; each block is absorbed at a segment
boundary under the lexicographic admission fence, so a streamed run is
bit-identical to pre-seeding the whole trace.

Entry point: ``CompiledSim.run(arrivals=source, backpressure=...)``.
"""

from repro_torch.stream.ingest import StreamFeeder
from repro_torch.stream.source import (
    ArrivalSource,
    BurstySource,
    DiurnalSource,
    PoissonSource,
    TraceReader,
    TraceWriter,
    source_events,
)

__all__ = [
    "ArrivalSource",
    "BurstySource",
    "DiurnalSource",
    "PoissonSource",
    "StreamFeeder",
    "TraceReader",
    "TraceWriter",
    "source_events",
]
