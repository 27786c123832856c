"""Training launcher (PyTorch port of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --reduced --device cpu \\
        --steps 50 --batch 8 --seq-len 64 --inject-crash 23

The JAX launcher's arguments and printout, plus ``--device``: the
default is the CUDA card, and the launcher raises without one.  The full
production loop: the deterministic data pipeline, the microbatched
(``--microbatches``) and optionally rematerialized (``--remat``) train
step, async atomic checkpoints, crash recovery and straggler
mitigation through :class:`~repro_torch.runtime.supervisor.
TrainSupervisor`.  The model is ``LM(cfg)`` with its default
``attn_impl="blockwise"``, as JAX's launcher builds it: the kernels have
no backward.  Weights are drawn from seed 0 (the port's generator, so
they are not JAX's), and a ``--resume`` from a checkpoint written by
either package's launcher continues on the same data.  minicpm trains
with the WSD schedule whatever ``--schedule`` says.  A config with
``input_mode="embeds"`` (hubert-xlarge, qwen2-vl-72b) trains on the
data pipeline's frame embeddings.  ``--reduced`` is the small
same-family config the CPU tests use.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ArchConfig, get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import LM
from repro_torch.runtime.supervisor import (
    FailureEvent,
    FailureInjector,
    SupervisorReport,
    TrainSupervisor,
)
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", default="cosine",
                   choices=["constant", "cosine", "wsd"])
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--inject-crash", type=int, default=None,
                   help="simulate a crash at this step (recovery demo)")
    p.add_argument("--inject-straggler", type=int, default=None)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: the supervisor's report, the final
    train state, and ``(step, loss, lr, grad_norm)`` of every step run
    (replays included), as floats."""
    report: SupervisorReport
    state: dict
    log: list


def train(cfg: ArchConfig, args: argparse.Namespace) -> TrainRun:
    """Train ``cfg`` as ``args`` says (the arguments of
    :func:`parse_args`; ``--arch`` and ``--reduced`` are the caller's),
    printing the JAX launcher's report."""
    # minicpm trains with the WSD schedule by default (its paper's setup)
    schedule = "wsd" if cfg.name.startswith("minicpm") else args.schedule
    # The weights live in the train state alone (ROADMAP A19).
    model = LM(cfg, device=args.device, weights=False)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=schedule,
                          total_steps=args.steps)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, input_mode=cfg.input_mode,
        d_model=cfg.d_model)

    def make_step(num_nodes):
        del num_nodes  # one card; the rebuilt step is the same
        return make_train_step(model, opt_cfg,
                               num_microbatches=args.microbatches,
                               remat=args.remat)

    state = init_train_state(model, 0)
    ckpt = CheckpointManager(args.ckpt_dir)
    if args.resume and ckpt.latest_step() is not None:
        state, at = ckpt.restore(state)
        print(f"resumed from checkpoint @ step {at}")

    events = []
    if args.inject_crash is not None:
        events.append(FailureEvent(step=args.inject_crash, kind="crash"))
    if args.inject_straggler is not None:
        events.append(FailureEvent(step=args.inject_straggler,
                                   kind="slow_node", node=0))

    sup = TrainSupervisor(
        make_step=make_step,
        make_batch=lambda step: make_batch(data_cfg, step, model.device),
        init_state=state, ckpt=ckpt, ckpt_every=args.ckpt_every,
        injector=FailureInjector(events))

    log = []
    inner = sup._step_fn

    def logged(state, batch):
        state, metrics = inner(state, batch)
        step = int(state["opt"]["step"])
        loss, lr, gnorm = (float(metrics[k])
                           for k in ("loss", "lr", "grad_norm"))
        log.append((step, loss, lr, gnorm))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} "
                  f"gnorm {gnorm:.3f}", flush=True)
        return state, metrics

    sup._step_fn = logged
    report = sup.run(args.steps)
    print(f"\ndone: {report.steps_run} steps, "
          f"{report.checkpoints_saved} checkpoints, "
          f"{report.restarts} restarts, "
          f"{report.straggler_mitigations} straggler mitigations; "
          f"final loss {report.final_loss:.4f}")
    for e in report.events:
        print("  event:", e)
    losses = [loss for _, loss, _, _ in log]
    if len(losses) > 10:
        first = sum(losses[:5]) / 5
        last = sum(losses[-5:]) / 5
        print(f"loss first5={first:.4f} last5={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return TrainRun(report=report, state=sup.state, log=log)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(cfg, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
