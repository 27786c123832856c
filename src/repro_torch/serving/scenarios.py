"""Device-compilable serving scenarios (DESIGN.md §8.2), PyTorch port.

Counterpart of :mod:`repro.serving.scenarios`: the serving control
plane's admission/decode/evict alphabet as a pure
:class:`~repro_torch.core.program.SimProgram`, so capacity planning
("what do 64k queued requests do to this admission policy?") runs on
the device engine's tiered3 queue.

Event alphabet (ids are registration order):

* ``ARRIVE`` (0) — a request joins the waiting pool and chains the next
  arrival (a counter-hashed gap on the exact f32 grid); also emits an
  ``ADMIT`` attempt one ``arrival_lookahead`` later.  Every emission
  carries its request index in ``arg[0]``.
* ``ADMIT`` (1) — admit the longest-waiting request into the first free
  slot (counter-hashed decode budget); with no free slot it re-emits
  itself one decode tick later.
* ``TICK``  (2) — one decode step for every active slot on the integer
  time grid; slots reaching zero finish and free themselves.  Re-emits
  itself while any work remains or can still arrive.

The state's leaves are int32 (the counters 0-d), and the hash relies on
int32 wraparound exactly as JAX's does: torch's int32 multiply wraps,
``abs`` of ``-2**31`` stays ``-2**31``, and ``%`` takes the divisor's
sign (``torch.remainder``, as ``jnp.remainder``; not ``torch.fmod``),
so the port's runs are bit-identical to the JAX package's.

The open variant (``build_open_admission_program``) takes its
arrivals from an external stream: ``sim.run(state0, arrivals=source)``
with a :class:`repro_torch.stream.PoissonSource` on the 0.25 grid, or,
for the closed reference, the same trace pre-seeded.
"""

from __future__ import annotations

import torch

from repro_torch.core.program import EMIT_WIDTH, Config, SimProgram

__all__ = [
    "build_admission_program",
    "build_open_admission_program",
    "initial_state",
    "make_open_program",
    "make_program",
]

_ARRIVE, _ADMIT, _TICK = 0.0, 1.0, 2.0


def _hash_mod(k, salt: int, mod: int):
    """Deterministic counter hash -> [0, mod), pure int32 (the same
    wraparound as JAX's)."""
    h = (k + salt) * 1103515245
    return torch.abs(h) % mod


def initial_state(num_slots: int, device="cpu"):
    """All-idle serving state: per-slot remaining decode budget plus the
    admission counters."""

    def counter():
        return torch.zeros((), dtype=torch.int32, device=device)

    return {
        "slots": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "waiting": counter(),
        "arrivals": counter(),
        "admitted": counter(),
        "served": counter(),
        "decoded": counter(),
        "retries": counter(),
    }


def build_admission_program(*, num_slots: int = 8, num_requests: int = 64,
                            max_decode: int = 6,
                            arrival_lookahead: float = 0.25,
                            config: Config | None = None) -> SimProgram:
    """Serving admission/decode/evict control plane as a SimProgram.

    ``num_requests`` bounds the arrival chain (so runs terminate);
    inter-arrival gaps are ``0.25 * (1 + hash % 8)``, which pins
    ``arrival_lookahead`` to exactly 0.25 (validated).  Decode budgets
    are ``1 + hash % max_decode`` ticks.
    """
    cfg = config or Config(max_batch_len=8, capacity=1024, max_emit=2)
    if cfg.max_emit < 2:
        raise ValueError("admission program needs Config(max_emit >= 2)")
    if arrival_lookahead != 0.25:
        raise ValueError(
            "arrival_lookahead must be exactly 0.25: it is ARRIVE's "
            "minimum emission delay AND its declared lookahead, it may "
            "not exceed the 0.25 minimum inter-arrival gap, and "
            "off-grid values (not a multiple of 0.25) silently break "
            "the cross-backend f32 timestamp parity this scenario "
            "asserts"
        )
    prog = SimProgram("serving-admission", config=cfg)

    def _blank(device):
        return torch.full((cfg.max_emit, EMIT_WIDTH), -1.0,
                          dtype=torch.float32, device=device)

    @prog.handler("ARRIVE", lookahead=arrival_lookahead, emits=True)
    def arrive(state, t, arg):
        k = state["arrivals"]
        state = dict(state, arrivals=k + 1, waiting=state["waiting"] + 1)
        gap = 0.25 * (1.0 + _hash_mod(k, 101, 8).to(torch.float32))
        more = (k + 1) < num_requests
        emits = _blank(t.device)
        emits[0, 0] = gap
        emits[0, 1] = torch.where(more, _ARRIVE, -1.0)
        emits[1, 0] = arrival_lookahead
        emits[1, 1] = _ADMIT
        # arg[0] = request index (the shard-routing slot; ignored here).
        emits[0, 2] = (k + 1).to(torch.float32)
        emits[1, 2] = k.to(torch.float32)
        return state, emits

    @prog.handler("ADMIT", lookahead=1.0, emits=True)
    def admit(state, t, arg):
        slots = state["slots"]
        free = slots <= 0
        any_free = torch.any(free)
        have_wait = state["waiting"] > 0
        do = have_wait & any_free
        took = do.to(torch.int32)
        # The first free slot (argmax returns the first maximum).
        slot = torch.argmax(free.to(torch.int32)).reshape(1)
        budget = 1 + _hash_mod(state["admitted"], 977, max_decode)
        slots = torch.where(do, slots.index_put((slot,), budget.reshape(1)),
                            slots)
        retry = have_wait & ~any_free
        state = dict(
            state, slots=slots,
            waiting=state["waiting"] - took,
            admitted=state["admitted"] + took,
            retries=state["retries"] + retry.to(torch.int32),
        )
        emits = _blank(t.device)
        emits[0, 0] = 1.0
        emits[0, 1] = torch.where(retry, _ADMIT, -1.0)
        emits[0, 2] = arg[0]   # retry keeps its request id
        return state, emits

    @prog.handler("TICK", lookahead=1.0, emits=True)
    def tick(state, t, arg):
        slots = state["slots"]
        active = slots > 0
        slots = torch.where(active, slots - 1, slots)
        finished = active & (slots == 0)
        state = dict(
            state, slots=slots,
            served=state["served"] + torch.sum(finished).to(torch.int32),
            decoded=state["decoded"] + torch.sum(active).to(torch.int32),
        )
        # Keep the cadence alive while anything is active, waiting, or
        # still to arrive.
        more = ((state["arrivals"] < num_requests)
                | (state["waiting"] > 0) | torch.any(slots > 0))
        emits = _blank(t.device)
        emits[0, 0] = 1.0
        emits[0, 1] = torch.where(more, _TICK, -1.0)
        # Routing key: the decode cadence is global, pinned to shard 0.
        emits[0, 2] = 0.0
        return state, emits

    prog.schedule(0.0, "ARRIVE")
    prog.schedule(1.0, "TICK")
    return prog.freeze()


def build_open_admission_program(*, num_slots: int = 8,
                                 num_requests: int = 64,
                                 max_decode: int = 6,
                                 config: Config | None = None
                                 ) -> SimProgram:
    """The admission scenario as an open system (DESIGN.md §10).

    The handlers of :func:`build_admission_program`, except that
    ``ARRIVE`` does not chain the next arrival: requests come from an
    external stream (``sim.run(state0, arrivals=source)``) or, for the
    closed reference, from pre-seeded ``ARRIVE`` events at the same
    times.  ``num_requests`` must equal the trace length: ``TICK`` keeps
    itself alive until that many arrivals have run.  Arrival times must
    lie on the 0.25 f32 grid (``PoissonSource(rate, n, grid=0.25,
    type_id=0)``), with the request index in ``arg[0]``.
    """
    cfg = config or Config(max_batch_len=8, capacity=1024, max_emit=2)
    if cfg.max_emit < 2:
        raise ValueError("admission program needs Config(max_emit >= 2)")
    prog = SimProgram("serving-admission-open", config=cfg)

    def _blank(device):
        return torch.full((cfg.max_emit, EMIT_WIDTH), -1.0,
                          dtype=torch.float32, device=device)

    @prog.handler("ARRIVE", lookahead=0.25, emits=True)
    def arrive(state, t, arg):
        k = state["arrivals"]
        state = dict(state, arrivals=k + 1, waiting=state["waiting"] + 1)
        emits = _blank(t.device)
        emits[0, 0] = 0.25
        emits[0, 1] = _ADMIT
        emits[0, 2] = k.to(torch.float32)
        return state, emits

    @prog.handler("ADMIT", lookahead=1.0, emits=True)
    def admit(state, t, arg):
        slots = state["slots"]
        free = slots <= 0
        any_free = torch.any(free)
        have_wait = state["waiting"] > 0
        do = have_wait & any_free
        took = do.to(torch.int32)
        slot = torch.argmax(free.to(torch.int32)).reshape(1)
        budget = 1 + _hash_mod(state["admitted"], 977, max_decode)
        slots = torch.where(do, slots.index_put((slot,), budget.reshape(1)),
                            slots)
        retry = have_wait & ~any_free
        state = dict(
            state, slots=slots,
            waiting=state["waiting"] - took,
            admitted=state["admitted"] + took,
            retries=state["retries"] + retry.to(torch.int32),
        )
        emits = _blank(t.device)
        emits[0, 0] = 1.0
        emits[0, 1] = torch.where(retry, _ADMIT, -1.0)
        emits[0, 2] = arg[0]
        return state, emits

    @prog.handler("TICK", lookahead=1.0, emits=True)
    def tick(state, t, arg):
        slots = state["slots"]
        active = slots > 0
        slots = torch.where(active, slots - 1, slots)
        finished = active & (slots == 0)
        state = dict(
            state, slots=slots,
            served=state["served"] + torch.sum(finished).to(torch.int32),
            decoded=state["decoded"] + torch.sum(active).to(torch.int32),
        )
        more = ((state["arrivals"] < num_requests)
                | (state["waiting"] > 0) | torch.any(slots > 0))
        emits = _blank(t.device)
        emits[0, 0] = 1.0
        emits[0, 1] = torch.where(more, _TICK, -1.0)
        emits[0, 2] = 0.0
        return state, emits

    prog.schedule(1.0, "TICK")
    # ARRIVE events come from the external stream, not the schedule.
    prog.external_entry("ARRIVE")
    return prog.freeze()


def make_program() -> SimProgram:
    """The closed admission scenario at smoke size with its example
    state declared."""
    prog = build_admission_program(num_slots=4, num_requests=16)
    return prog.example_state(initial_state(4))


def make_open_program() -> SimProgram:
    """The open variant at smoke size (external ARRIVE stream declared
    with ``external_entry``)."""
    prog = build_open_admission_program(num_slots=4, num_requests=16)
    return prog.example_state(initial_state(4))
