"""The paper's synthetic proof-of-concept model (§IV.A), PyTorch port.

Two event types over a global u32 ``sum``: ``Increment`` runs K
iterations of ``sum += sum + 1`` (``sum <- 2*sum + 1``), ``Set`` stores
``sum <- 10``.  The state is held in an int64 tensor with an explicit
``& 0xFFFFFFFF`` after each step — the u32 wraparound of the JAX model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import Config, SimProgram

SET_VALUE = 10
INCREMENT, SET = 0, 1  # type ids, in registration order
_M32 = 0xFFFFFFFF


def increment_body(sum_, iters: int):
    """K iterations of ``sum += sum + 1`` as an explicit loop."""
    for _ in range(iters):
        sum_ = (sum_ * 2 + 1) & _M32
    return sum_


def build_program(iters: int, lookahead: float = 1_000_000.0,
                  config: Config | None = None) -> SimProgram:
    """The PoC model: the paper's two handlers."""
    prog = SimProgram("poc", config=config or Config(max_batch_len=4))

    @prog.handler("Increment", lookahead=lookahead)
    def increment(state, t, arg):
        del t, arg
        return increment_body(state, iters)

    @prog.handler("Set", lookahead=lookahead)
    def set_(state, t, arg):
        del t, arg
        return torch.full_like(state, SET_VALUE)

    return prog


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
            twoK = pow(2, iters, 1 << 32)
            s = (twoK * s + twoK - 1) & _M32
    return s
