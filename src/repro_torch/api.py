"""`repro_torch.api` — the supported way to define and run simulations
on the PyTorch port.

    from repro_torch.api import Config, SimProgram

    prog = SimProgram("demo", config=Config(max_batch_len=4))

    @prog.handler("TICK", lookahead=1.0)
    def tick(state, t, arg):
        return state + 1

    prog.schedule(0.0, "TICK")
    result = prog.build(backend="device").run(torch.tensor(0))

``build(backend="device")`` runs on the CUDA card; pass ``device="cpu"``
to run the same program on the CPU.  The port has :mod:`repro.api`'s
device backend: every queue mode (``queue_mode="tiered3"|"tiered"|
"flat"|"reference"``), the sharded engine (``shards=N``, ``shard_fn=``,
``placement="serial"|"devices"``), the three dispatch modes (``switch``,
``masked``, and ``fused`` with ``hot_words``), the entity-parallel run
path (``@prog.entity_handler``), the invariant auditor
(``validate="cheap"|"full"``), the overflow policies
(``overflow="error"|"spill"``), and segmented runs: checkpoints
(``run(checkpoint_every=, checkpoint_dir=, resume_from=)``) and
streamed arrivals (``run(arrivals=, backpressure=)``).  It also has
the host backend, ``build(backend="host", scheduler="conservative"|
"speculative"|"unbatched", composer="lazy"|"eager")``, which compiles
each batch word with ``torch.compile`` unless ``jit_handlers=False``.
The static analyzer is :func:`analyze` (``build(check="warn"|
"error")``, ``hot_words="static"``, ``python -m repro_torch.analysis
module:callable``).  ``build(shards=N, placement="devices")`` runs one
shard queue a rank over ``torch.distributed`` (a default process group
of N ranks: gloo on the CPU, NCCL on N cards).

Open-system runs stream arrivals from a host-side source:
``sim.run(state0, arrivals=PoissonSource(...))`` (see
:mod:`repro_torch.stream`).
"""

from repro_torch.analysis import Finding, ProgramReport, analyze
from repro_torch.core.events import ARG_WIDTH, emits_events
from repro_torch.core.program import (
    EMIT_WIDTH,
    AnalysisError,
    CompiledSim,
    Config,
    RunResult,
    SimProgram,
    normalize_arg,
    state_from_numpy,
)
from repro_torch.core.validate import (
    FAULT_NAMES,
    EngineFaultError,
    fault_names,
)
from repro_torch.stream import (
    ArrivalSource,
    BurstySource,
    DiurnalSource,
    PoissonSource,
    StreamFeeder,
    TraceReader,
    TraceWriter,
    source_events,
)

__all__ = [
    "ARG_WIDTH",
    "EMIT_WIDTH",
    "AnalysisError",
    "ArrivalSource",
    "BurstySource",
    "CompiledSim",
    "Config",
    "DiurnalSource",
    "EngineFaultError",
    "FAULT_NAMES",
    "Finding",
    "PoissonSource",
    "ProgramReport",
    "RunResult",
    "SimProgram",
    "StreamFeeder",
    "TraceReader",
    "TraceWriter",
    "analyze",
    "emits_events",
    "fault_names",
    "normalize_arg",
    "source_events",
    "state_from_numpy",
]
