"""The paper's §IV.A wireless-broadcast sketch on the PyTorch port.

"Suppose a node in a simulated network periodically broadcasts messages
to nearby receivers.  The successful reception depends on whether the
receiver is in a power-saving state.  If none of the nearby nodes is
ready to receive, the computations involved in the creation of the
message could be avoided entirely."

The model of ``examples/wireless_des.py``, with its three events, its
schedule and its configuration:

* SleepAll  — every receiver enters power saving (awake = 0);
* WakeAll   — every receiver wakes (awake = 1);
* Broadcast — the sender builds an expensive message (a 100,000-step
  LCG) and delivers it to the awake receivers.

The u32 state is held in int64 with an explicit ``& 0xFFFFFFFF``, as
PHOLD's hashes are, so ``inbox + awake * msg`` wraps mod 2**32 as JAX's
does.

The message.  JAX runs the LCG ``m = m * 1664525 + 1013904223`` as a
``lax.fori_loop``, which XLA compiles as one loop.  A Python loop of
100,000 steps would trace to 300k graph nodes, which Dynamo unrolls.
Here the steps are affine maps mod 2**32, and composing affine maps is
associative: a ``2**17``-long tensor holds the step ``(a, c)`` 100,000
times and the identity ``(1, 0)`` after, and 17 levels each compose
adjacent pairs, ``(a2, c2) o (a1, c1) = (a2 a1, a2 c1 + c2)``.  The last
pair applied to the seed 12345 is the sequential LCG's result bit for
bit.  The work grows with ``MSG_WORK`` (131,071 pair compositions), runs
eagerly in milliseconds and traces to about 250 aten nodes.  Products
are taken mod 2**32 from 16-bit halves, so no int64 product overflows.

The cross-event check (``cross_event_check``, run by :func:`main` on the
card): the words ``[SleepAll, Broadcast, WakeAll]`` (nobody can
receive) and ``[WakeAll, Broadcast, SleepAll]`` are composed from the
host registry and compiled whole by Inductor
(:func:`repro_torch.core.composer.compile_fn`); the check reports
whether the message's work (its LCG multiplier) appears in each word's
generated code and each word's warm device time.  XLA drops the dead
word's loop; whether Inductor does is the finding it reports.

    python -m repro_torch.examples.wireless_des    # on the card
"""

from __future__ import annotations

import time

import torch

from repro_torch.api import Config, SimProgram
from repro_torch.core.composer import compile_fn, compose_word_fn

N_RECEIVERS = 4
MSG_WORK = 100_000
SLEEP, WAKE, BCAST = 0, 1, 2  # registration-order type ids

_M32 = 0xFFFFFFFF
LCG_A, LCG_C, LCG_SEED = 1664525, 1013904223, 12345
_LEVELS = (MSG_WORK - 1).bit_length()     # 2**17 >= MSG_WORK


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors in ``[0, 2**32)``, from the
    16-bit halves of ``b`` (no product reaches 2**49)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def message(device) -> torch.Tensor:
    """The LCG after ``MSG_WORK`` steps from ``LCG_SEED``: an int64
    ``[1]`` tensor in ``[0, 2**32)`` on ``device``."""
    live = torch.arange(1 << _LEVELS, device=device) < MSG_WORK
    a = torch.where(live, LCG_A, 1)
    c = torch.where(live, LCG_C, 0)
    for _ in range(_LEVELS):
        a1, a2 = a.view(-1, 2).unbind(1)      # a1's step comes first
        c1, c2 = c.view(-1, 2).unbind(1)
        a, c = _mul32(a2, a1), (_mul32(a2, c1) + c2) & _M32
    return (_mul32(a, torch.full_like(a, LCG_SEED)) + c) & _M32


def build_program() -> SimProgram:
    prog = SimProgram("wireless", config=Config(max_batch_len=2,
                                                capacity=64))

    @prog.handler("SleepAll")
    def sleep_all(state, t, arg):
        return {**state, "awake": torch.zeros_like(state["awake"])}

    @prog.handler("WakeAll")
    def wake_all(state, t, arg):
        return {**state, "awake": torch.ones_like(state["awake"])}

    @prog.handler("Broadcast")
    def broadcast(state, t, arg):
        # expensive message construction, delivery gated by power state
        msg = message(state["inbox"].device)
        delivered = (state["inbox"] + state["awake"] * msg) & _M32
        return {**state, "inbox": delivered}

    # day/night duty cycle with periodic broadcasts
    for day in range(8):
        base = day * 10.0
        prog.schedule(base + 0.0, "SleepAll")
        prog.schedule(base + 1.0, "Broadcast")
        prog.schedule(base + 2.0, "Broadcast")
        prog.schedule(base + 5.0, "WakeAll")
        prog.schedule(base + 6.0, "Broadcast")
    return prog


def initial_state(device="cpu"):
    return {
        "awake": torch.ones((N_RECEIVERS,), dtype=torch.int64,
                            device=device),
        "inbox": torch.zeros((N_RECEIVERS,), dtype=torch.int64,
                             device=device),
    }


def make_program() -> SimProgram:
    """Analyzer/CLI target: the paper §IV.A wireless scenario with its
    example state declared."""
    return build_program().example_state(initial_state())


def run_all(device=None, *, jit_handlers: bool = True) -> dict:
    """The same program on the host scheduler (``conservative``) and on
    the device engine in the two-tier queue at capacity 4096 and the
    flat queue at 64: ``{"host", "tiered", "flat"}`` -> RunResult.
    ``device=None`` is the card; ``jit_handlers`` compiles each host
    batch word."""
    prog = build_program()
    out = {"host": prog.build(
        backend="host", scheduler="conservative", device=device,
        jit_handlers=jit_handlers).run(initial_state())}
    for queue_mode, capacity in (("tiered", 4096), ("flat", 64)):
        dev = prog.build(backend="device", queue_mode=queue_mode,
                         capacity=capacity, device=device)
        out[queue_mode] = dev.run(initial_state())
    return out


def _word_ms(fn, args, device, reps: int) -> float:
    """Warm milliseconds a call: CUDA events around ``reps`` calls on
    the card, the host clock on the CPU."""
    fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) * 1e3 / reps


def cross_event_check(device=None, *, reps: int = 50) -> dict:
    """Compile the dead word ``[SleepAll, Broadcast, WakeAll]`` and the
    live word ``[WakeAll, Broadcast, SleepAll]`` with Inductor and
    report, for each, whether the message's work is in the generated
    code (its multiplier ``LCG_A`` appears) and its warm milliseconds a
    call; ``ratio`` is dead over live.  A finding, not a gate."""
    from torch._inductor.utils import run_and_get_code

    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    reg = build_program().host_registry()
    ts = torch.tensor([0.0, 1.0, 2.0], device=dev)
    args = torch.zeros((3, 4), device=dev)
    out = {}
    for name, word in (("dead", [SLEEP, BCAST, WAKE]),
                       ("live", [WAKE, BCAST, SLEEP])):
        fn = compile_fn(compose_word_fn(reg, word), f"{name} word")
        state = initial_state(dev)
        (new_state, _), code = run_and_get_code(fn, state, ts, args)
        out[f"{name}_work_in_code"] = any(str(LCG_A) in c for c in code)
        out[f"{name}_inbox"] = new_state["inbox"].tolist()
        out[f"{name}_ms"] = _word_ms(fn, (state, ts, args), dev, reps)
    out["ratio"] = out["dead_ms"] / out["live_ms"]
    return out


def main(device=None) -> None:
    # cross-event DCE check: [SleepAll, Broadcast, WakeAll] -> no one can
    # receive, so the message's work may disappear from the compiled word.
    check = cross_event_check(device)
    print("message work removed when all receivers sleep:",
          not check["dead_work_in_code"])
    print("message work present when receivers awake:   ",
          check["live_work_in_code"])
    print(f"warm ms a word call: dead {check['dead_ms']:.6f}, live "
          f"{check['live_ms']:.6f} (ratio {check['ratio']:.4f})")

    runs = run_all(device)
    res = runs["host"]
    print(f"host run: batches executed: {res.batches} "
          f"(mean len {res.mean_batch_length:.1f}); "
          f"final inbox: {res.state['inbox'].tolist()}")
    for queue_mode, capacity in (("tiered", 4096), ("flat", 64)):
        dres = runs[queue_mode]
        same = dres.state["inbox"].tolist() == res.state["inbox"].tolist()
        print(f"on-device engine [{queue_mode:6s} queue, "
              f"capacity {capacity:4d}]: batches={dres.batches} "
              f"events={dres.events} "
              f"dropped={dres.dropped}; matches host run: {same}")


if __name__ == "__main__":
    main()
