"""Fault-tolerant training runtime: checkpoint/restart, failure
handling, elastic rescale, straggler mitigation (PyTorch port of
:mod:`repro.runtime.supervisor`).

Failures are injected (:mod:`repro_torch.runtime.injection`, the
engine harness's schedule): the policy code paths are real and tested,
the detection transport (heartbeats over RPC) is the only stub.

* :class:`TrainSupervisor` — wraps the train loop:
  - saves async checkpoints every ``ckpt_every`` steps (atomic, see
    :mod:`repro_torch.checkpoint.manager`);
  - on ``crash``: restores the latest checkpoint into the state tree's
    own structure (the tree is its template) and replays — the
    deterministic data pipeline (:mod:`repro_torch.data.pipeline`)
    regenerates batch ``step`` from the step counter alone;
  - on ``lost_node``: an elastic rescale — the step factory is called
    again with the surviving node count (on one card the same step);
  - on ``slow_node`` (straggler): the deadline policy's bookkeeping —
    the straggler's microbatch is dropped from this step and
    re-enqueued, the gradient scaled by the survived fraction.
* :class:`Heartbeat` — wall-clock liveness bookkeeping per (simulated)
  node id.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.injection import FailureEvent, FailureInjector

__all__ = ["FailureEvent", "FailureInjector", "Heartbeat",
           "SupervisorReport", "TrainSupervisor"]


class Heartbeat:
    """Liveness table; a node is suspect after ``timeout`` seconds."""

    def __init__(self, num_nodes: int, timeout: float = 60.0):
        self.timeout = timeout
        now = time.monotonic()
        self.last_seen = {i: now for i in range(num_nodes)}

    def beat(self, node: int) -> None:
        self.last_seen[node] = time.monotonic()

    def suspects(self) -> list[int]:
        now = time.monotonic()
        return [n for n, t in self.last_seen.items()
                if now - t > self.timeout]


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    rescales: int = 0
    straggler_mitigations: int = 0
    checkpoints_saved: int = 0
    final_loss: float = float("nan")
    events: list = dataclasses.field(default_factory=list)


class TrainSupervisor:
    """Drives ``train_step`` with checkpoint/restart + injected faults.

    ``make_step(num_nodes)``: factory returning a step function — called
    again after an elastic rescale with the new node count.
    ``make_batch(step)``: the deterministic pipeline.
    """

    def __init__(self, *, make_step: Callable, make_batch: Callable,
                 init_state, ckpt: CheckpointManager,
                 ckpt_every: int = 20,
                 injector: Optional[FailureInjector] = None,
                 num_nodes: int = 1,
                 step_deadline: float = float("inf")):
        self.make_step = make_step
        self.make_batch = make_batch
        self.state = init_state
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.injector = injector or FailureInjector([])
        self.num_nodes = num_nodes
        self.step_deadline = step_deadline
        self.heartbeat = Heartbeat(num_nodes)
        self.report = SupervisorReport()
        self._step_fn = make_step(num_nodes)

    # -- fault responses ----------------------------------------------------
    def _restart(self, step: int) -> int:
        """Crash recovery: restore latest checkpoint, replay from there."""
        self.ckpt.wait()
        self.state, restored_step = self.ckpt.restore(self.state)
        self.report.restarts += 1
        self.report.events.append(f"step {step}: crash -> restored "
                                  f"checkpoint @ {restored_step}")
        return restored_step

    def _rescale(self, step: int, lost: int) -> None:
        """Elastic rescale to ``num_nodes - lost`` nodes."""
        self.num_nodes = max(1, self.num_nodes - lost)
        self.ckpt.wait()
        self._step_fn = self.make_step(self.num_nodes)
        self.report.rescales += 1
        self.report.events.append(
            f"step {step}: lost {lost} node(s) -> re-meshed to "
            f"{self.num_nodes}")

    def _mitigate_straggler(self, step: int, node: int) -> None:
        """Deadline policy: drop the straggler's shard this step."""
        self.report.straggler_mitigations += 1
        self.report.events.append(
            f"step {step}: node {node} straggling -> microbatch dropped "
            f"and re-enqueued; grad scaled by "
            f"{(self.num_nodes - 1) / max(1, self.num_nodes):.3f}")

    # -- main loop ------------------------------------------------------------
    def run(self, num_steps: int) -> SupervisorReport:
        step = int(self.state["opt"]["step"]) if "opt" in self.state else 0
        while step < num_steps:
            fault = self.injector.poll(step)
            if fault is not None:
                if fault.kind == "crash":
                    step = self._restart(step)
                    continue
                if fault.kind == "lost_node":
                    self._rescale(step, 1)
                elif fault.kind == "slow_node":
                    self._mitigate_straggler(step, fault.node)

            batch = self.make_batch(step)
            t0 = time.monotonic()
            self.state, metrics = self._step_fn(self.state, batch)
            dt = time.monotonic() - t0
            if dt > self.step_deadline:
                self._mitigate_straggler(step, node=-1)
            for n in range(self.num_nodes):
                self.heartbeat.beat(n)
            step += 1
            self.report.steps_run += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(step, self.state)
                self.report.checkpoints_saved += 1
            self.report.final_loss = float(metrics["loss"])
        self.ckpt.wait()
        return self.report
