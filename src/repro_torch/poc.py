"""The paper's synthetic proof-of-concept model (§IV.A), PyTorch port.

Counterpart of :mod:`repro.poc`.  Two event types over a global u32
``sum``:

* ``Increment`` — K iterations of ``sum += sum + 1`` (paper: K = 1e6),
  i.e. ``sum <- 2*sum + 1``, a loop whose result is observable only
  through the final value of ``sum``;
* ``Set`` — ``sum <- 10``, a constant store.

When a batch holds ``Increment`` followed (eventually) by ``Set``, the
increment loop is dead code within the batch's composed program, and a
compiler that sees the whole word may remove it: clang in the paper,
XLA in the JAX package, Inductor here when the host composers compile
each word (``jit_handlers=True``).

The state is held in an int64 tensor with an explicit ``& 0xFFFFFFFF``
after each step: the u32 wraparound of the JAX model.  The loop is a
Python loop, which ``torch.compile`` unrolls, so compile time grows
with K: compile at small K (the tests and ``chip_smoke.py`` use 16 or
64).  Neither event schedules new events, so any lookahead is valid;
the paper uses 1e6, so every batch reaches the maximum length.
"""

from __future__ import annotations

import numpy as np
import torch

SET_VALUE = 10
PAPER_ITERS = 1_000_000     # paper §IV.A
DEFAULT_ITERS = 100_000     # the JAX package's default
INCREMENT, SET = 0, 1       # type ids, in registration order
_M32 = 0xFFFFFFFF


def increment_body(sum_, iters: int):
    """K iterations of ``sum += sum + 1`` as an explicit loop."""
    for _ in range(iters):
        sum_ = (sum_ * 2 + 1) & _M32
    return sum_


def _handlers(iters: int):
    def increment(state, t, arg):
        del t, arg
        return increment_body(state, iters)

    def set_(state, t, arg):
        del t, arg
        return torch.full_like(state, SET_VALUE)

    return increment, set_


def build_registry(iters: int = DEFAULT_ITERS,
                   lookahead: float = 1_000_000.0):
    """Registry with the paper's two event types (``(state, t, arg) ->
    state``; ``state`` is the global ``sum``, ``arg`` is unused)."""
    from repro_torch.core.events import EventRegistry

    reg = EventRegistry()
    increment, set_ = _handlers(iters)
    reg.register("Increment", increment, lookahead=lookahead)
    reg.register("Set", set_, lookahead=lookahead)
    return reg.freeze()


def build_program(iters: int = DEFAULT_ITERS,
                  lookahead: float = 1_000_000.0, config=None):
    """The PoC model as a :class:`repro_torch.api.SimProgram`: the same
    two handlers, declared once and compilable to every runtime."""
    from repro_torch.core.program import Config, SimProgram

    prog = SimProgram("poc", config=config or Config(max_batch_len=4))
    increment, set_ = _handlers(iters)
    prog.register("Increment", increment, lookahead=lookahead)
    prog.register("Set", set_, lookahead=lookahead)
    return prog


ANALYSIS_ITERS = 16          # the analyzer target's K


def make_program():
    """The PoC model with its example state and entry points declared
    (the §IV.B workload is injected with ``run(events=...)``, so both
    types are external entries): the analyzer's target.  Tracing runs
    the Python loop, one graph node an iteration, so the target keeps K
    small; neither handler emits, so its report does not depend on K."""
    prog = build_program(ANALYSIS_ITERS)
    prog.external_entry("Increment", "Set")
    return prog.example_state(initial_state())


def initial_state(device="cpu"):
    return torch.tensor(0, dtype=torch.int64, device=device)


def schedule_poc_events(num_events: int, p_set: float, seed: int):
    """§IV.B workload: one event per integer time step, type ~
    Bernoulli(p_set).  Returns a list of (time, type_id) pairs."""
    rng = np.random.default_rng(seed)
    types = np.where(rng.random(num_events) < p_set, SET, INCREMENT)
    return [(float(t), int(ty)) for t, ty in enumerate(types)]


def reference_final_sum(types, iters: int) -> int:
    """Pure-Python oracle for the final value of ``sum`` (mod 2^32)."""
    s = 0
    for ty in types:
        if ty == SET:
            s = SET_VALUE
        else:
            # 2^K * s + (2^K - 1) mod 2^32 (closed form of K doublings).
            twoK = pow(2, iters, 1 << 32)
            s = (twoK * s + twoK - 1) & _M32
    return s


def s_max(n: int, p_i: float) -> float:
    """Analytic maximum speedup (paper Corollary 1)."""
    if p_i <= 0.0:
        return float(n)
    if p_i >= 1.0:
        return 1.0
    return n * (1.0 - p_i) / (1.0 - p_i ** n)
