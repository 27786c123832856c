"""A tandem M/M/c queueing network on the PyTorch port.

The model of ``examples/mmc_network.py`` with the same arithmetic:
``K`` stations in series, each with ``c`` servers.  Customers enter at
station 0 (a self-scheduling arrival source), are served (queueing when
all ``c`` servers are busy) and hop to the next station on departure.
The entity-parallel TALLY type samples every station's queue length on
a fixed grid: all K tallies share one timestamp, so the window is a run
of one type and the engine runs it as one ``torch.func.vmap`` over the
stations (``@prog.entity_handler``).

Service and interarrival times are counter-based hashes on the 0.25
time grid, so the port's runs are bit-identical to the JAX package's.
The hash is u32 arithmetic, held in int64 with an explicit
``& 0xFFFFFFFF`` after each multiply and add (as in
:mod:`repro_torch.examples.phold`); the state's leaves stay int32.

    PYTHONPATH=src python -m repro_torch.examples.mmc_network \
        [--stations 4] [--tiny] [--device cpu]

runs the network under the three dispatch modes and checks that they
agree bit for bit; without ``--device`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.api import ARG_WIDTH, Config, SimProgram

ARRIVE, DEPART, TALLY = 0, 1, 2  # registration-order type ids
C_SERVERS = 2
_M32 = 0xFFFFFFFF

BACKENDS = {
    "device/switch": dict(backend="device", dispatch_mode="switch"),
    "device/masked": dict(backend="device", dispatch_mode="masked"),
    "device/fused": dict(backend="device", dispatch_mode="fused"),
}
LEAVES = ("qlen", "busy", "served", "arrived", "area", "samples")


def _mix(t, station, salt: int):
    """Counter-based hash of (time, station, stream): exact on the 0.25
    time grid."""
    t4 = (t * 4.0).to(torch.int64)
    h = (t4 * 2654435761 + station.to(torch.int64) * 40503
         + salt * 97) & _M32
    h = h ^ (h >> 13)
    h = (h * 0x5BD1E995) & _M32
    return h ^ (h >> 15)


def _delay(h, lo: float = 0.5, steps: int = 8):
    """Grid-exact pseudo-exponential delay in {lo, lo+0.25, ...}."""
    return lo + (h % steps).to(torch.float32) * 0.25


def _set_row(emits, i: int, cond, delay, type_id: int, a0, a1=0.0):
    """Emit row ``i`` as (delay, type, a0, a1, 0...); ν when ``cond`` is
    False."""
    emits[i, 0] = delay
    emits[i, 1] = torch.where(cond, float(type_id), -1.0)
    emits[i, 2] = a0
    emits[i, 3] = a1


def build_program(num_stations: int = 4, t_open: float = 30.0,
                  tally_every: float = 5.0, max_batch_len: int | None = None,
                  capacity: int = 512) -> SimProgram:
    """The network model.  ``max_batch_len`` defaults to the station
    count so a tally grid point fills exactly one vmapped window."""
    K = num_stations
    max_batch_len = K if max_batch_len is None else max_batch_len
    prog = SimProgram(
        "mmc_network",
        config=Config(max_batch_len=max_batch_len, capacity=capacity,
                      max_emit=2),
    )

    @prog.handler("ARRIVE", lookahead=0.5, emits=True)
    def arrive(state, t, arg):
        s = arg[0].to(torch.int32)
        at = s.to(torch.int64).reshape(1)
        is_source = arg[1] > 0.5  # the self-scheduling external stream
        service = _delay(_mix(t, s, 17))
        busy, qlen, arrived = state["busy"], state["qlen"], state["arrived"]
        free = busy.index_select(0, at) < C_SERVERS
        took = free.to(torch.int32)
        # In place: the engine runs on its own copy of the state.
        busy.index_add_(0, at, took)
        qlen.index_add_(0, at, 1 - took)
        arrived.index_add_(0, at, torch.ones_like(took))
        next_gap = _delay(_mix(t, s, 23), lo=0.5, steps=6)
        emits = torch.zeros((2, 2 + ARG_WIDTH), dtype=torch.float32,
                            device=t.device)
        # free server: begin service now, schedule the departure
        _set_row(emits, 0, free[0], service, DEPART, s.to(torch.float32))
        # external source keeps itself alive while the doors are open
        _set_row(emits, 1, is_source & (t < t_open), next_gap, ARRIVE,
                 0.0, 1.0)
        return state, emits

    @prog.handler("DEPART", lookahead=0.5, emits=True)
    def depart(state, t, arg):
        s = arg[0].to(torch.int32)
        at = s.to(torch.int64).reshape(1)
        service = _delay(_mix(t, s, 29))
        busy, qlen, served = state["busy"], state["qlen"], state["served"]
        waiting = qlen.index_select(0, at) > 0
        w = waiting.to(torch.int32)
        qlen.index_add_(0, at, -w)
        busy.index_add_(0, at, w - 1)
        served.index_add_(0, at, torch.ones_like(w))
        route = s < K - 1
        emits = torch.zeros((2, 2 + ARG_WIDTH), dtype=torch.float32,
                            device=t.device)
        # a waiting customer takes the freed server immediately
        _set_row(emits, 0, waiting[0], service, DEPART, s.to(torch.float32))
        # the finished customer hops to the next station in series
        _set_row(emits, 1, route, 0.5, ARRIVE, (s + 1).to(torch.float32))
        return state, emits

    @prog.entity_handler("TALLY", lookahead=1.0)
    def tally(entity_state, t, arg):
        # Entity-local: `entity_state` is one station's slice of every
        # state leaf.  Integrates queue length over the sample grid.
        return {
            **entity_state,
            "area": entity_state["area"] + entity_state["qlen"],
            "samples": entity_state["samples"] + 1,
        }

    prog.schedule(0.0, "ARRIVE", arg=[0.0, 1.0])
    g = tally_every
    while g < t_open + 10.0:
        for s in range(K):
            prog.schedule(g, "TALLY", arg=[float(s)])
        g += tally_every
    return prog


def initial_state(num_stations: int, device="cpu"):
    return {leaf: torch.zeros((num_stations,), dtype=torch.int32,
                              device=device)
            for leaf in LEAVES}


def make_program() -> SimProgram:
    """Smoke-size M/M/c network with its example state declared."""
    prog = build_program(num_stations=4, t_open=15.0)
    return prog.example_state(initial_state(4))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stations", type=int, default=4)
    ap.add_argument("--t-open", type=float, default=30.0)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke sizes (3 stations, short horizon)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    K = 3 if args.tiny else args.stations
    t_open = 10.0 if args.tiny else args.t_open

    results = {}
    for label, build_kw in BACKENDS.items():
        prog = build_program(num_stations=K, t_open=t_open)
        res = prog.build(device=args.device, **build_kw).run(
            initial_state(K))
        results[label] = res
        print(f"{label:20s} events={res.events:5d} batches={res.batches:5d} "
              f"(mean len {res.mean_batch_length:4.2f}) "
              f"served={res.state['served'].tolist()}")

    base = results["device/switch"]
    for label, res in results.items():
        for leaf in LEAVES:
            assert torch.equal(res.state[leaf], base.state[leaf]), (label,
                                                                    leaf)
        assert (res.events, res.batches, res.dropped) == (
            base.events, base.batches, base.dropped), label

    st = {leaf: base.state[leaf].cpu() for leaf in LEAVES}
    # conservation: everyone who arrived is served, queued, or in service
    assert torch.equal(st["arrived"], st["served"] + st["qlen"] + st["busy"])
    mean_q = st["area"] / st["samples"].clamp(min=1)
    print(f"\nall {len(results)} dispatch modes agree bit-for-bit; "
          f"mean queue length per station: "
          f"{[round(x, 2) for x in mean_q.tolist()]}")


if __name__ == "__main__":
    main()
