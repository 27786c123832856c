#!/usr/bin/env python3
"""What this host's PyTorch can capture into a CUDA graph with
conditional nodes, as the device engine's captured loop needs them.

    python3 scripts/torch_capture_probe.py [--json PATH] [--only NAME]

Each check captures a small graph with
``repro_torch.core.capture.capture_graph`` (``torch.cuda.graph`` with
the port's IF nodes, ``src/repro_torch/csrc/graph_cond.cu``) and
replays it, and prints one line ``CHECK name ok=... detail``:

* ``api``: whether this PyTorch binds IF nodes itself
  (``CUDAGraph.begin_capture_to_if_node`` and its kin: reported, not
  needed) and has what the port's binding needs, ``torch.cuda.MemPool``
  and routing allocations to a pool by thread;
* ``if_node``: an IF node on a 0-d bool, replayed with the predicate
  true and false;
* ``nested``: an IF node inside an IF node's body, all four cases;
* ``alloc``: a body that allocates (a 1,048,576-element f32 sort, a
  cumsum, a searchsorted, a scatter_add_ and index_copy) and writes the
  results back into tensors made before the capture;
* ``ctypes``: ``window_extract`` and ``front_merge`` (the ctypes
  launches of ``src/repro_torch/csrc/queue_front.cu``) inside an IF
  body, against the same calls made eagerly, and their launches counted
  from the body's executions (two of three replays);
* ``loop``: a one-step graph whose body sits under ``IF(active)``,
  replayed K times past the loop's end (the body's steps stop at N);
* ``switch``: a SWITCH node over 3 bodies on an int32, each index in
  and out of range, and ``cond``/``select`` writing a functional body's
  results back into a NamedTuple carry;
* ``timing``: ms a replay of an empty IF node, of 64 untaken IF nodes,
  and of a 48-op body, taken and untaken (CUDA events, 200 replays);
  and of a SWITCH node over 2, 16 and 128 bodies of 20 ops, one taken,
  with the host's ms a ``replay()`` call beside it;
* ``nccl``: a one-rank NCCL group in this process, its communicator
  warmed with a barrier; ``all_gather_rows`` (the list form of
  ``all_gather``, as the sharded engine's ``placement="devices"``
  gathers) captured at the graph's top level and inside an IF body,
  each replayed against the same gather made eagerly, with the IF
  taken and untaken, and the collectives counted from the replays; in
  the ``thread_local`` capture mode (the engine's for a devices step:
  NCCL's watchdog thread queries events meanwhile), which must pass,
  and in the ``global`` mode, reported;
* ``sync_ops``: which of ``bincount``, ``repeat_interleave`` with an
  int, ``nonzero`` and an index by a 0-d tensor a capture refuses (each
  in a child process of its own: a refused capture may leave the
  process unusable).

Needs a CUDA device.  Prints the card (``nvidia-smi`` name and power
limit) and ``torch``/CUDA versions first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

RESULTS: dict = {}


def report(name: str, ok: bool, **detail) -> None:
    RESULTS[name] = dict(ok=bool(ok), **detail)
    print(f"CHECK {name} ok={bool(ok)} "
          + " ".join(f"{k}={v}" for k, v in detail.items()), flush=True)


def capture(fn, mode="global"):
    """``fn`` captured into a new graph through
    :func:`repro_torch.core.capture.capture_graph` (conditional nodes
    from ``csrc/graph_cond.cu``) in the capture mode ``mode``; returns
    the ``CapturedStep``, which must outlive the graph's replays."""
    import torch

    from repro_torch.core import capture as cap

    return cap.capture_graph(torch.device("cuda", 0), fn, mode=mode)


def if_body(pred):
    from repro_torch.core.capture import when

    return when(pred)


def check(name, fn):
    try:
        fn()
    except Exception as err:  # report and go on to the next check
        report(name, False, error=json.dumps(f"{type(err).__name__}: "
                                             f"{err}"[:400]))


def check_api():
    import torch

    names = ("get_currently_capturing_graph", "begin_capture_to_if_node",
             "end_capture_to_conditional_node")
    have = {n: hasattr(torch.cuda.CUDAGraph, n) for n in names}
    have["MemPool"] = hasattr(torch.cuda, "MemPool")
    have["thread_pool_routing"] = hasattr(
        torch._C, "_cuda_beginAllocateCurrentThreadToPool")
    # The port's own binding needs only the last two.
    report("api", have["MemPool"] and have["thread_pool_routing"], **have)


def check_if_node():
    import torch

    x = torch.zeros((), dtype=torch.int32, device="cuda")
    pred = torch.zeros((), dtype=torch.bool, device="cuda")

    def step():
        with if_body(pred) as taken:
            assert taken
            x.add_(1)

    g = capture(step)
    got = []
    for p in (True, False, True):
        pred.fill_(p)
        g.replay()
        got.append(int(x))
    report("if_node", got == [1, 1, 2], values=got)


def check_nested():
    import torch

    x = torch.zeros((), dtype=torch.int32, device="cuda")
    p1 = torch.zeros((), dtype=torch.bool, device="cuda")
    p2 = torch.zeros((), dtype=torch.bool, device="cuda")

    def step():
        with if_body(p1):
            x.add_(1)
            with if_body(p2):
                x.add_(10)

    g = capture(step)
    got = []
    for a, b in ((False, False), (False, True), (True, False), (True, True)):
        p1.fill_(a)
        p2.fill_(b)
        x.zero_()
        g.replay()
        got.append(int(x))
    report("nested", got == [0, 0, 1, 11], values=got)


def check_alloc():
    import torch

    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(0)
    keys = torch.rand(n, device="cuda", generator=gen)
    out_sorted = torch.zeros(n, device="cuda")
    out_cum = torch.zeros(n, dtype=torch.int64, device="cuda")
    out_pos = torch.zeros(64, dtype=torch.int32, device="cuda")
    out_hist = torch.zeros(10, dtype=torch.int32, device="cuda")
    out_copy = torch.zeros(n, device="cuda")
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    probe = torch.linspace(0, 1, 64, device="cuda")

    def body_ops():
        s = torch.sort(keys, stable=True).values
        out_sorted.copy_(s)
        out_cum.copy_(torch.cumsum((keys > 0.5).to(torch.int32), 0))
        out_pos.copy_(torch.searchsorted(s, probe, right=True,
                                         out_int32=True))
        bins = torch.clamp((keys * 10).to(torch.int64), 0, 9)
        out_hist.copy_(torch.zeros(10, dtype=torch.int32, device="cuda")
                       .scatter_add_(0, bins, torch.ones_like(
                           bins, dtype=torch.int32)))
        idx = torch.arange(n, device="cuda").flip(0)
        out_copy.copy_(torch.zeros(n, device="cuda").index_copy(0, idx,
                                                                keys))

    def step():
        with if_body(pred):
            body_ops()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body_ops()
    torch.cuda.current_stream().wait_stream(side)
    want = [t.clone() for t in (out_sorted, out_cum, out_pos, out_hist,
                                out_copy)]
    for t in (out_sorted, out_cum, out_pos, out_hist, out_copy):
        t.zero_()
    torch.cuda.reset_peak_memory_stats()
    g = capture(step)
    g.replay()
    got = (out_sorted, out_cum, out_pos, out_hist, out_copy)
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    for t in got:
        t.zero_()
    pred.fill_(False)
    g.replay()
    untouched = all(int(torch.count_nonzero(t)) == 0 for t in got)
    report("alloc", all(same) and untouched, same=same,
           untaken_writes_nothing=untouched,
           peak_mb=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")


def _front(gen, F, front_n, W=4):
    import torch

    t = torch.sort(torch.randint(0, 64, (F,), generator=gen)
                   .to(torch.float32) * 0.5).values
    live = torch.arange(F) < front_n
    times = torch.where(live, t, float("inf"))
    types = torch.where(live, torch.randint(0, 3, (F,), generator=gen), -1)
    args = torch.where(live[:, None], torch.rand(F, W, generator=gen), 0.0)
    seqs = torch.where(live, torch.arange(F), 2**31 - 1)
    return [times, types.to(torch.int32), args, seqs.to(torch.int32)]


def check_ctypes():
    import torch

    from repro_torch.kernels import queue_front as qf

    gen = torch.Generator().manual_seed(1)
    F, k, R = 256, 4, 8
    front = [x.cuda() for x in _front(gen, F, 200)]
    la = torch.tensor([1.0, 0.5, 2.0], device="cuda")
    front_n = torch.tensor(200, dtype=torch.int32, device="cuda")
    t_r = (torch.randint(0, 80, (R,), generator=gen).to(torch.float32)
           * 0.5).cuda()
    ty_r = torch.randint(0, 3, (R,), generator=gen).to(torch.int32).cuda()
    arg_r = torch.rand(R, 4, generator=gen).cuda()
    seq_r = (1000 + torch.arange(R, dtype=torch.int32)).cuda()
    to_front = (torch.rand(R, generator=gen) < 0.7).cuda()

    def calls():
        ext = qf.window_extract(*front, la, None, k=k)
        mer = qf.front_merge(*front, front_n, t_r, ty_r, arg_r, seq_r,
                             to_front)
        return list(ext) + list(mer)

    want = calls()
    outs = [torch.zeros_like(w) for w in want]
    pred = torch.ones((), dtype=torch.bool, device="cuda")

    def step():
        with if_body(pred):
            for o, v in zip(outs, calls()):
                o.copy_(v)

    g = capture(step)
    ctx = g.ctx
    qf.reset_launches()
    g.replay()
    same = [bool(torch.equal(o, w)) for o, w in zip(outs, want)]
    pred.fill_(False)
    g.replay()
    pred.fill_(True)
    g.replay()
    counts = ctx.counters[:ctx.used].tolist()
    ctx.fold(counts, replays=3)
    launches = dict(qf.LAUNCHES)
    ok = all(same) and launches == {"window_extract": 2, "front_merge": 2}
    report("ctypes", ok, outputs=len(same), equal=sum(same),
           launches=json.dumps(launches))


def check_loop():
    import torch

    N, K = 40, 64
    counter = torch.zeros((), dtype=torch.int64, device="cuda")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    acc = torch.zeros(1024, device="cuda")

    def step():
        with if_body(active):
            counter.add_(1)
            acc.add_(counter.to(torch.float32))
            active.copy_(counter < N)

    g = capture(step)
    t0 = time.perf_counter()
    for _ in range(K):
        g.replay()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    got = int(counter)
    want_acc = float(N * (N + 1) / 2)
    ok = got == N and float(acc[0]) == want_acc and not bool(active)
    report("loop", ok, steps=got, replays=K, acc=float(acc[0]),
           host_ms_per_replay=f"{host_s * 1e3 / K:.4f}")


def check_switch():
    import collections

    import torch

    from repro_torch.core.capture import cond, select

    Carry = collections.namedtuple("Carry", "a b")
    carry = Carry(torch.zeros(4, device="cuda"),
                  torch.zeros((), dtype=torch.int32, device="cuda"))
    index = torch.zeros((), dtype=torch.int32, device="cuda")
    flag = torch.zeros((), dtype=torch.bool, device="cuda")

    def branch(k):
        return lambda c: Carry(c.a + k, c.b * 10 + k)

    def step():
        c = select(index, [branch(1), branch(2), branch(3)], carry)
        cond(flag, lambda c: c._replace(b=c.b + 100), c)

    g = capture(step)
    got = []
    for i, f in ((0, False), (2, False), (1, True), (5, False), (-1, True)):
        index.fill_(i)
        flag.fill_(f)
        g.replay()
        got.append((carry.a.tolist()[0], int(carry.b)))
    want = [(1.0, 1), (4.0, 13), (6.0, 232), (6.0, 232), (6.0, 332)]
    report("switch", got == want, values=json.dumps(got),
           nodes=json.dumps(dict(g.ctx.nodes)))


def check_nccl():
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.core import queue as tq
    from repro_torch.core.capture import cond

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    out, oks = {}, {}
    try:
        group = dist.group.WORLD
        # thread_local first (the mode the engine captures a devices
        # step in): a global capture that NCCL's watchdog breaks may
        # leave the process unusable.
        for mode in ("thread_local", "global"):
            try:
                oks[mode], out[mode] = _nccl_case(torch, dist, tq, cond,
                                                  group, mode)
            except Exception as err:  # report the mode, go on
                oks[mode] = False
                out[mode] = f"{type(err).__name__}: {err}"[:300]
    finally:
        dist.destroy_process_group()
    report("nccl", oks["thread_local"],
           **{mode: json.dumps(v) for mode, v in out.items()})


def _nccl_case(torch, dist, tq, cond, group, mode):
    """One rank's ``all_gather_rows`` captured in ``mode`` at the top
    level and in an IF body, each right after a barrier (NCCL's
    watchdog then holds a work to query while the capture runs)."""
    dist.barrier(device_ids=[torch.cuda.current_device()])
    x = torch.arange(12, dtype=torch.int32, device="cuda").reshape(3, 4)
    top = torch.zeros_like(x)
    inner = torch.zeros_like(x)
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    want = tq.all_gather_rows(x, group)

    def step():
        top.copy_(tq.all_gather_rows(x, group))
        cond(pred, lambda c: tq.all_gather_rows(x, group) + 1, inner)

    tq.COUNTS.clear()
    g = capture(step, mode=mode)
    got = []
    for p in (True, False, True):
        x.add_(100)
        pred.fill_(p)
        g.replay()
        torch.cuda.synchronize()
        got.append((bool(torch.equal(top, x)),
                    bool(torch.equal(inner, x + 1)) if p else None))
    counts = g.ctx.counters[:g.ctx.used].tolist()
    g.ctx.fold(counts, replays=3)
    folded = tq.COUNTS.get("collectives", 0)
    ok = (bool(torch.equal(want.cpu(), torch.arange(12).reshape(3, 4)
                           .to(torch.int32)))
          and all(a for a, _ in got)
          and [b for _, b in got if b is not None] == [True, True]
          and folded == 5)
    return ok, dict(replays=got, collectives=folded,
                    nodes=dict(g.ctx.nodes))


def _replay_ms(graph, replays=200) -> float:
    import torch

    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def check_timing():
    import torch

    pred = torch.zeros((), dtype=torch.bool, device="cuda")
    x = torch.zeros(256, device="cuda")

    def empty_if():
        with if_body(pred):
            x.add_(1)

    def many_ifs():
        for _ in range(64):
            with if_body(pred):
                x.add_(1)

    def body48():
        with if_body(pred):
            y = x
            for i in range(48):
                y = y * 1.0001 + i
            x.copy_(y)

    def plain48():
        y = x
        for i in range(48):
            y = y * 1.0001 + i
        x.copy_(y)

    index = torch.zeros((), dtype=torch.int32, device="cuda")

    def switch_of(n):
        from repro_torch.core.capture import select

        def body(c):
            y = c
            for i in range(20):
                y = y * 1.0001 + i
            return y

        return lambda: select(index, [body] * n, x)

    out = {}
    for name, fn in (("one_if", empty_if), ("if64", many_ifs),
                     ("body48", body48), ("plain48", plain48)):
        g = capture(fn)
        for p in (False, True):
            if name == "plain48" and p:
                continue
            pred.fill_(p)
            out[f"{name}_{'taken' if p else 'untaken'}_ms"] = \
                f"{_replay_ms(g):.5f}"
        del g
    # A SWITCH node's cost against its body count, one body taken: the
    # replay's host launch grows with every body's nodes.
    for n in (2, 16, 128):
        g = capture(switch_of(n))
        out[f"switch{n}_x20_ms"] = f"{_replay_ms(g):.5f}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            g.replay()
        out[f"switch{n}_x20_host_ms"] = \
            f"{(time.perf_counter() - t0) * 1e3 / 50:.5f}"
        torch.cuda.synchronize()
        del g
    report("timing", True, **out)


SYNC_OPS = {
    "repeat_interleave_int": lambda torch, idx: torch.repeat_interleave(
        idx, 4),
    "bincount_minlength": lambda torch, idx: torch.bincount(idx,
                                                            minlength=8),
    "nonzero": lambda torch, idx: torch.nonzero(idx),
    "index_by_0d": lambda torch, idx: idx[idx[1]],
}


def sync_op_child(name: str) -> int:
    """One op of :data:`SYNC_OPS` captured in an IF body, in a process of
    its own: a refused capture may leave the process unusable."""
    import torch

    pred = torch.ones((), dtype=torch.bool, device="cuda")
    idx = torch.tensor([0, 1, 1, 3], device="cuda")
    SYNC_OPS[name](torch, idx)
    torch.cuda.synchronize()

    def step():
        with if_body(pred):
            SYNC_OPS[name](torch, idx)

    g = capture(step)
    g.replay()
    torch.cuda.synchronize()
    print("CAPTURED", flush=True)
    return 0


def check_sync_ops():
    out = {}
    for name in SYNC_OPS:
        proc = subprocess.run(
            [sys.executable, __file__, "--sync-op", name],
            capture_output=True, text=True, timeout=300)
        if "CAPTURED" in proc.stdout:
            out[name] = "captured"
        else:
            last = (proc.stderr.strip().splitlines() or ["?"])[-1]
            out[name] = json.dumps(f"refused (exit {proc.returncode}): "
                                   f"{last[:120]}")
    report("sync_ops", True, **out)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--only", action="append",
                    help="run only this check (repeatable)")
    ap.add_argument("--sync-op", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sync_op:
        return sync_op_child(args.sync_op)
    if not torch.cuda.is_available():
        print("torch_capture_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"CARD {card} torch={torch.__version__} cuda={torch.version.cuda}",
          flush=True)
    RESULTS["card"] = card
    RESULTS["torch"] = torch.__version__
    for name, fn in (("api", check_api), ("if_node", check_if_node),
                     ("nested", check_nested), ("alloc", check_alloc),
                     ("ctypes", check_ctypes), ("loop", check_loop),
                     ("switch", check_switch), ("nccl", check_nccl),
                     ("timing", check_timing), ("sync_ops", check_sync_ops)):
        if args.only is None or name in args.only:
            check(name, fn)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(RESULTS, indent=1))
    ok = all(r["ok"] for k, r in RESULTS.items() if isinstance(r, dict))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
