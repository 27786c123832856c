"""Event-driven serving engine: continuous batching as a DES (PyTorch
port of :mod:`repro.serving.engine`).

The serving control plane IS a discrete-event simulation:

* ``ARRIVE``  — a request joins; lookahead = the trace's minimum
  inter-arrival gap.
* ``PREFILL`` — prompt processed into a cache slot.
* ``DECODE``  — one generation step for every active slot, pre-scheduled
  on the integer time grid; its lookahead is the arrival lookahead.
* ``EVICT``   — slot freed when a sequence finishes.

The paper's compile-time event batching applies directly: *runs* of
DECODE events inside the dynamic lookahead window are dispatched to
composed **k-step decode programs**.  In the JAX package that program
is one ``jax.jit`` of a ``lax.scan``; here it is a loop of k
``decode_step`` calls whose greedy ``argmax`` and ``active`` select stay
on the card, so the k steps are issued back to back with exactly one
host read per decode batch — the ``[slots, k]`` tokens
(``ServeStats.host_reads`` counts them).  Capturing the k steps in a
CUDA graph is later work.

Mixed windows (a DECODE run interrupted by an ARRIVE) fall back to
per-event execution, exactly like a batch whose window closes early.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core.program import SimProgram
from repro_torch.core.queue import HostEventQueue
from repro_torch.core.scheduler import extract_window
from repro_torch.models import LM

ARRIVE, PREFILL, DECODE, EVICT = 0, 1, 2, 3


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    arrival: float
    slot: int = -1
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    finish_time: float = -1.0


@dataclasses.dataclass
class ServeStats:
    decode_events: int = 0
    fused_batches: int = 0
    fused_events: int = 0
    singles: int = 0
    prefills: int = 0
    compiled_programs: dict = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0
    # Port-side counters: device-to-host reads of decode tokens, decode
    # batches that ran (one read each), and the host-clock seconds spent
    # in prefills and decode batches (each ends in a host read, so the
    # card's work is inside the interval).
    host_reads: int = 0
    decode_batches: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0

    @property
    def mean_fused_length(self) -> float:
        return self.fused_events / self.fused_batches if self.fused_batches \
            else 0.0


class ServingEngine:
    def __init__(self, model: LM, *, max_slots: int = 8,
                 max_len: int = 256, max_batch_len: int = 4,
                 arrival_lookahead: float = 4.0,
                 prompt_buckets=(32, 64, 128)):
        self.model = model
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.max_batch_len = max_batch_len
        self.arrival_lookahead = arrival_lookahead
        self.prompt_buckets = tuple(sorted(prompt_buckets))

        self.cache = model.init_cache(max_slots, max_len)
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.waiting: list[Request] = []
        self.requests: dict[int, Request] = {}
        self.stats = ServeStats()

        # --- composed k-step decode programs, one per run length k ---
        self._decode_k_programs: dict = {}

        # --- the event alphabet (paper §III-A: constant handler array),
        # declared on a SimProgram; the control plane keeps its own run
        # loop, so it consumes the program's host registry directly.
        prog = SimProgram("serving-control-plane")
        prog.register("ARRIVE", self._h_arrive, lookahead=arrival_lookahead)
        prog.register("PREFILL", self._h_prefill, lookahead=0.0)
        # DECODE lookahead = arrival lookahead: a decode emits only
        # EVICTs, which cannot affect other DECODEs in the window (slot
        # reuse needs a PREFILL, gated by the ARRIVE lookahead).
        prog.register("DECODE", self._h_decode_single,
                      lookahead=arrival_lookahead)
        prog.register("EVICT", self._h_evict, lookahead=0.0)
        self.program = prog.freeze()
        self.registry = prog.host_registry()
        self.queue = HostEventQueue()

    # ------------------------------------------------------------------
    # Composed programs (the compile-time batching)
    # ------------------------------------------------------------------
    def _decode_k(self, k: int):
        """The k-step decode program: k (decode_step -> greedy sample)
        iterations issued back to back, tokens kept on the card."""
        if k not in self._decode_k_programs:
            model = self.model

            def fused(cache, tokens, active):
                toks = []
                for _ in range(k):
                    logits, cache = model.decode_step(cache, tokens)
                    # argmax returns the first maximum, as jnp.argmax.
                    nxt = torch.argmax(logits[:, -1], dim=-1)
                    tokens = torch.where(active, nxt, tokens[:, 0]).to(
                        torch.int32)[:, None]
                    toks.append(tokens[:, 0])
                return cache, torch.stack(toks, dim=1)      # [B, k]

            self._decode_k_programs[k] = fused
            # Nothing is compiled here (the JAX package records its jit
            # time); the key keeps the launcher's printout.
            self.stats.compiled_programs[f"decode_{k}"] = 0.0
        return self._decode_k_programs[k]

    def _prefill_bucket(self, length: int) -> int:
        # Recurrent mixers (mamba/rwkv) carry state across EVERY token,
        # so right-padding a prompt would corrupt the state: use exact
        # lengths, as the JAX engine does.  Attention-only archs use
        # buckets (lengths mask the padded cache tail).
        if any(spec.mixer in ("mamba", "rwkv")
               for pattern, _ in self.model.cfg.stages()
               for spec in pattern):
            return length
        for b in self.prompt_buckets:
            if length <= b:
                return b
        return self.prompt_buckets[-1]

    def _prefill_one(self, tokens, length: int):
        """tokens [1, bucket] -> (next token [1] on the card, cache).

        As the JAX program: the prefill builds the cache, and a second
        full ``forward`` recomputes the last VALID logit (the bucket may
        pad past the prompt)."""
        model = self.model
        logits, cache = model.prefill(tokens, max_len=self.max_len)
        del logits
        full_logits, _ = model.forward(tokens)
        last = full_logits[:, length - 1]
        return torch.argmax(last, dim=-1).to(torch.int32), cache

    # ------------------------------------------------------------------
    # Event handlers (host side; device work inside)
    # ------------------------------------------------------------------
    def _h_arrive(self, state, t, req: Request):
        self.waiting.append(req)
        self.queue.push(float(t), PREFILL, None)
        return state

    def _free_slot(self) -> int:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return -1

    def _h_prefill(self, state, t, arg):
        if not self.waiting:
            return state
        slot = self._free_slot()
        if slot < 0:   # no capacity: retry after the next decode tick
            self.queue.push(float(t) + 1.0, PREFILL, None)
            return state
        t0 = time.perf_counter()
        req = self.waiting.pop(0)
        req.slot = slot
        self.slot_req[slot] = req
        bucket = self._prefill_bucket(len(req.prompt))
        toks = torch.zeros((1, bucket), dtype=torch.int32)
        toks[0, :len(req.prompt)] = torch.tensor(req.prompt,
                                                 dtype=torch.int32)
        nxt, cache1 = self._prefill_one(toks.to(self.device),
                                        len(req.prompt))
        # splice the single-slot cache into the global slot cache
        self.cache = _splice_slot(self.cache, cache1, slot)
        self.cache["lengths"][slot] = len(req.prompt)
        req.output.append(int(nxt[0]))
        self.stats.prefills += 1
        self.stats.prefill_seconds += time.perf_counter() - t0
        return state

    def _pending_tokens_default(self):
        toks = [r.output[-1] if r is not None and r.output else 0
                for r in self.slot_req]
        return torch.tensor(toks, dtype=torch.int32)[:, None].to(self.device)

    def _active_list(self) -> list:
        return [r is not None and not r.done for r in self.slot_req]

    def _h_decode_single(self, state, t, arg):
        """Fallback: one DECODE event executed alone."""
        self._decode_run(1, float(t))
        self.stats.singles += 1
        return state

    def _h_evict(self, state, t, arg):
        for i, r in enumerate(self.slot_req):
            if r is not None and r.done:
                self.slot_req[i] = None
                self.cache["lengths"][i] = 0
        return state

    # ------------------------------------------------------------------
    # Decode execution (single or fused run)
    # ------------------------------------------------------------------
    def _decode_run(self, k: int, t_end: float):
        active = self._active_list()
        if not any(active):
            return
        t0 = time.perf_counter()
        tokens = self._pending_tokens_default()
        active_t = torch.tensor(active, dtype=torch.bool).to(self.device)
        prog = self._decode_k(k)
        self.cache, toks = prog(self.cache, tokens, active_t)
        toks = toks.tolist()                     # [slots, k]: one host read
        self.stats.host_reads += 1
        self.stats.decode_batches += 1
        self.stats.decode_events += k
        for i, r in enumerate(self.slot_req):
            if r is None or r.done:
                continue
            for j in range(k):
                r.output.append(int(toks[i][j]))
                if len(r.output) >= r.max_new_tokens:
                    r.done = True
                    r.finish_time = t_end
                    self.queue.push(t_end, EVICT, None)
                    break
        self.stats.decode_seconds += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Main loop: lookahead-window batch extraction (paper §III-B)
    # ------------------------------------------------------------------
    def submit(self, rid: int, prompt, max_new_tokens: int, at: float):
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, arrival=at)
        self.requests[rid] = req
        self.queue.push(at, ARRIVE, req)
        return req

    def schedule_decode_grid(self, t0: float, t1: float):
        """Pre-schedule the decode cadence (one event per integer t)."""
        t = float(t0)
        while t <= t1:
            self.queue.push(t, DECODE, None)
            t += 1.0

    def run(self, *, max_events: int | None = None):
        t_start = time.perf_counter()
        processed = 0
        budget = float("inf") if max_events is None else max_events
        while self.queue and processed < budget:
            batch = extract_window(self.queue, self.registry,
                                   self.max_batch_len)
            types = [ev.type_id for ev in batch]
            if all(ty == DECODE for ty in types) and len(batch) > 1:
                # the composed-batch fast path
                self._decode_run(len(batch), batch[-1].time)
                self.stats.fused_batches += 1
                self.stats.fused_events += len(batch)
            else:
                for ev in batch:
                    et = self.registry[ev.type_id]
                    et.handler(None, ev.time, ev.arg)
            processed += len(batch)
            # stop once every submitted request finished (only the
            # pre-scheduled decode grid remains in the queue)
            if self.requests and all(r.done
                                     for r in self.requests.values()):
                break
        self.stats.wall_seconds = time.perf_counter() - t_start
        return self.stats


def _splice_slot(cache, cache1, slot: int):
    """Write the single-sequence cache1 (batch size 1) into ``slot`` of
    the multi-slot cache in place (stage leaves are ``[L, B, ...]``)."""
    for stage, stage1 in zip(cache["stages"], cache1["stages"]):
        for lj, layer in stage.items():
            for name, big in layer.items():
                big[:, slot] = stage1[lj][name][:, 0].to(big.dtype)
    return cache
