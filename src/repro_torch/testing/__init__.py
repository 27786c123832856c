"""Test-support harnesses that ship with the port (not pytest-only):
fault injection for the device engine (:mod:`repro_torch.testing.faults`),
runnable standalone with ``python -m repro_torch.testing.faults``.
"""

from repro_torch.testing.faults import (
    CORRUPTIONS,
    SimulatedCrash,
    run_all_scenarios,
    run_corruption_scenario,
    run_crash_scenario,
    run_overflow_scenario,
    tiny_phold,
)

__all__ = [
    "CORRUPTIONS",
    "SimulatedCrash",
    "run_all_scenarios",
    "run_corruption_scenario",
    "run_crash_scenario",
    "run_overflow_scenario",
    "tiny_phold",
]
