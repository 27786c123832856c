"""PHOLD on the PyTorch port.

PHOLD is the standard synthetic PDES benchmark (Fujimoto, 1990): a
constant population of messages hops between logical processes (LPs);
each executed hop schedules exactly one future hop at a pseudo-random
LP with a pseudo-random delay.  This is the model of
``examples/phold.py`` with the same arithmetic: the randomness is a
counter-based hash of ``(time, lp)`` and every delay is a multiple of
0.5, so the port's runs are bit-identical to the JAX package's.

The hash and the checksum are u32 arithmetic.  They are held in int64
with an explicit ``& 0xFFFFFFFF`` after each multiply or add, and the
right shifts act on the masked (non-negative) value, so they are the
logical shifts of u32.
"""

from __future__ import annotations

import torch

from repro_torch.api import ARG_WIDTH, Config, SimProgram

HOP = 0  # single-type alphabet: registration order id
_M32 = 0xFFFFFFFF


def _mix(t, src):
    """Counter-based hash of (time, lp) in u32 arithmetic.  Times stay
    on the 0.5 grid, so ``2t`` is an exact integer in f32."""
    t2 = (t * 2.0).to(torch.int64)
    h = (t2 * 2654435761 + src * 40503 + 12345) & _M32
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & _M32
    return h ^ (h >> 15)


def build_program(num_lps: int = 8, t_stop: float = 40.0,
                  max_batch_len: int = 4, capacity: int = 256) -> SimProgram:
    """The PHOLD model: one emitting HOP type, one initial hop per LP
    (LP ``i`` at time ``0.5 * i``)."""
    prog = SimProgram(
        "phold",
        config=Config(max_batch_len=max_batch_len, capacity=capacity,
                      max_emit=1),
    )

    @prog.handler("HOP", lookahead=1.0, emits=True)
    def hop(state, t, arg):
        src = arg[0].to(torch.int64)
        h = _mix(t, src)
        # delay in {1.0, 1.5, ..., 4.5} >= the declared lookahead;
        # destination is any OTHER lp.
        delay = 1.0 + (h % 8).to(torch.float32) * 0.5
        dst = (src + 1 + (h // 8) % (num_lps - 1)) % num_lps
        counts = state["counts"]
        # In place: the engine runs on its own copy of the state.
        counts.index_add_(0, src.reshape(1),
                          torch.ones(1, dtype=counts.dtype,
                                     device=counts.device))
        checksum = (state["checksum"] * 31 + h) & _M32
        emit = torch.zeros((1, 2 + ARG_WIDTH), dtype=torch.float32,
                           device=t.device)
        emit[0, 0] = delay
        emit[0, 1] = torch.where(t < t_stop, 0.0, -1.0)
        emit[0, 2] = dst.to(torch.float32)
        return {"counts": counts, "checksum": checksum}, emit

    for lp in range(num_lps):
        prog.schedule(0.5 * lp, "HOP", arg=[float(lp)])
    return prog


def initial_state(num_lps: int, device="cpu"):
    return {
        "counts": torch.zeros((num_lps,), dtype=torch.int32, device=device),
        "checksum": torch.tensor(1, dtype=torch.int64, device=device),
    }


def make_program() -> SimProgram:
    """Analyzer/CLI target: smoke-size PHOLD with its example state
    declared (``python -m repro_torch.analysis
    repro_torch.examples.phold:make_program``)."""
    prog = build_program(num_lps=8, t_stop=20.0)
    return prog.example_state(initial_state(8))
