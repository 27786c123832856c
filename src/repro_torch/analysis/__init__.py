"""Static analysis for SimProgram models (PyTorch port of
:mod:`repro.analysis`).

``analyze(prog)`` traces every handler abstractly (fake tensors: no
event executes, no kernel launches) and returns a
:class:`ProgramReport`: the event-flow graph with per-edge delay
bounds, lookahead-soundness verdicts, reachability and dead-handler
info, emit-row sanitation, a purity lint, and the statically reachable
compositions that feed ``build(dispatch_mode="fused",
hot_words="static")``.

CLI: ``python -m repro_torch.analysis repro_torch.examples.phold:make_program``.
"""

from repro_torch.analysis.graph import EmitEdge, HandlerNode, extract_graph
from repro_torch.analysis.passes import Finding, ProgramReport, analyze

__all__ = [
    "analyze",
    "ProgramReport",
    "Finding",
    "HandlerNode",
    "EmitEdge",
    "extract_graph",
]
