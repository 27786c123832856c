"""The port's data pipeline, train supervisor and training launcher
(``repro_torch.data``, ``repro_torch.runtime.supervisor``,
``repro_torch.launch.train``) against the JAX package's.

* ``make_batch``/``shard_slice``: bit-identical to JAX's for seeds 0 and
  3 and steps 0-63 (the keys and uniform draws first, then the tokens);
  the f64 power rounded to f32 lands every token on JAX's (0 of the
  tokens drawn here differ).
* The counterparts of ``tests/test_substrates.py``'s data, supervisor,
  microbatch and compression tests, with the same assertions.
* A checkpoint written by JAX's launcher resumes in the port's: JAX's
  launcher runs reduced stablelm-12b for 6 steps in a child process
  (``--xla_allow_excess_precision=false``, see ``test_torch_lm.py``),
  checkpointing at step 4 and printing every step's loss; the port's
  launcher resumes that checkpoint for steps 5 and 6, whose losses must
  match JAX's printed ones within ``LOSS_TOL``, the train-step test's
  tolerance (``tests/test_torch_training.py``), plus the printout's
  rounding to 4 decimals.  Their gradient norms (step 5's taken on the
  restored weights themselves) match within ``GNORM_RTOL``, that test's
  too, plus the rounding to 3 decimals.  The two printouts have the same
  lines.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.tree import key_leaves
from repro_torch.data import prng
from repro_torch.data.pipeline import DataConfig, make_batch, shard_slice
from repro_torch.launch import train as ttrain
from repro_torch.models import LM
from repro_torch.runtime.supervisor import (
    FailureEvent,
    FailureInjector,
    TrainSupervisor,
)
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 2e-3 + 5e-5
GNORM_RTOL, GNORM_PRINTED = 1e-2, 5e-4
DATA_CFGS = ((256, 16, 8), (49155, 64, 8))     # (vocab, seq_len, batch)
RESUME_ARGS = ["--arch", "stablelm-12b", "--reduced", "--steps", "6",
               "--ckpt-every", "4", "--log-every", "1"]


def _bits(key, shape):
    """JAX's 32 random bits of ``shape`` under ``key``."""
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(
        np.int64)


@pytest.mark.parametrize("seed", (0, 3))
def test_keys_and_uniform_bits_match_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(np.asarray(key).astype(np.int64), tkey.numpy())
    for step in range(64):
        k = jax.random.split(jax.random.fold_in(key, step), 3)
        tk = prng.split(prng.fold_in(tkey, step), 3)
        assert np.array_equal(np.asarray(k).astype(np.int64), tk.numpy())
        assert np.array_equal(_bits(k[0], (8, 64)),
                              prng.random_bits(tk[0], (8, 64)).numpy())
        u = jax.random.uniform(k[0], (8, 64), minval=1e-6, maxval=1.0)
        tu = prng.uniform(tk[0], (8, 64), 1e-6, 1.0)
        assert np.array_equal(np.asarray(u).view(np.int32),
                              tu.numpy().view(np.int32)), step


@pytest.mark.parametrize("seed", (0, 3))
def test_make_batch_and_shard_slice_match_jax(seed):
    mismatched = 0
    for vocab, seq, batch in DATA_CFGS:
        jcfg = jpipe.DataConfig(vocab, seq, batch, seed=seed)
        cfg = DataConfig(vocab, seq, batch, seed=seed)
        for step in range(64):
            want = np.asarray(jpipe.make_batch(jcfg, step)["tokens"])
            got = make_batch(cfg, step)
            assert got["tokens"].dtype == torch.int32
            assert got["labels"] is got["tokens"]
            mismatched += int((got["tokens"].numpy() != want).sum())
        for shard in range(4):
            want = np.asarray(jpipe.shard_slice(jcfg, 5, shard, 4)["tokens"])
            assert np.array_equal(shard_slice(cfg, 5, shard, 4)[
                "tokens"].numpy(), want)
    assert mismatched == 0


def test_data_deterministic_and_restart_safe():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    b1 = make_batch(cfg, 7)
    b2 = make_batch(cfg, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = make_batch(cfg, 8)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < 1000
    # an embeds batch: JAX's Zipf labels bit for bit, and its normal draw
    # within 3 f32 ulps (tests/test_torch_mrope.py counts the elements)
    cfg = DataConfig(8, 4, 2, input_mode="embeds", d_model=4)
    got = make_batch(cfg, 0)
    want = jpipe.make_batch(jpipe.DataConfig(8, 4, 2, input_mode="embeds",
                                             d_model=4), 0)
    assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_array_max_ulp(got["embeds"].numpy(),
                                    np.asarray(want["embeds"]), maxulp=3)
    assert torch.equal(make_batch(cfg, 0)["embeds"], got["embeds"])


def test_data_shard_slices_partition_global_batch():
    cfg = DataConfig(vocab_size=100, seq_len=4, global_batch=8)
    full = make_batch(cfg, 0)
    parts = [shard_slice(cfg, 0, s, 4)["tokens"] for s in range(4)]
    assert torch.equal(torch.cat(parts, 0), full["tokens"])
    with pytest.raises(ValueError):
        shard_slice(cfg, 0, 0, 3)


def test_supervisor_crash_recovery(tmp_path):
    cfg = get_config("stablelm-12b").reduced()
    model = LM(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)

    def make_step(n):
        return make_train_step(model, opt_cfg)

    state = init_train_state(model, 0)
    sup = TrainSupervisor(
        make_step=make_step, make_batch=lambda s: make_batch(dc, s),
        init_state=state, ckpt=CheckpointManager(str(tmp_path)),
        ckpt_every=4,
        injector=FailureInjector([
            FailureEvent(step=6, kind="crash"),
            FailureEvent(step=9, kind="slow_node", node=0),
        ]))
    report = sup.run(12)
    assert report.restarts == 1
    assert report.straggler_mitigations == 1
    assert int(sup.state["opt"]["step"]) == 12
    # crash at 6 restores ckpt@4 and replays 4..6: extra steps run
    assert report.steps_run == 12 + 2
    assert np.isfinite(report.final_loss)
    assert report.checkpoints_saved == 3        # @4, @8, @12
    assert report.events == [
        "step 6: crash -> restored checkpoint @ 4",
        "step 9: node 0 straggling -> microbatch dropped and re-enqueued; "
        "grad scaled by 0.000"]
    # the restored state took the live tree's structure, dtypes, device
    restored, _ = sup.ckpt.restore(sup.state, step=4)
    assert int(restored["opt"]["step"]) == 4
    assert restored["params"]["embed"].dtype == torch.bfloat16


def test_microbatched_grads_match_full_batch():
    cfg = get_config("stablelm-12b").reduced()
    model = LM(cfg, device="cpu")
    state = init_train_state(model, 1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    batch = make_batch(dc, 0)
    s1 = make_train_step(model, AdamWConfig(), num_microbatches=1,
                         remat=False)
    s4 = make_train_step(model, AdamWConfig(), num_microbatches=4,
                         remat=False)
    _, m1 = s1(state, batch)
    _, m4 = s4(state, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    assert abs(float(m1["grad_norm"]) - float(m4["grad_norm"])) < 5e-2


def test_train_step_with_compression_descends():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = LM(cfg, device="cpu")
    state = init_train_state(model, 0, compression=True)
    assert "ef" in state
    step = make_train_step(model, AdamWConfig(lr=1e-3), num_microbatches=2,
                           remat=False)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    losses = []
    for i in range(6):
        state, metrics = step(state, make_batch(dc, i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    for (pe, e), (pp, p) in zip(key_leaves(state["ef"]),
                                key_leaves(state["params"])):
        assert pe == pp and e.shape == p.shape and e.dtype == torch.float32
    assert any(bool(e.any()) for _, e in key_leaves(state["ef"]))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

_STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) lr (\S+) gnorm (\S+)")


def _shape(text: str) -> list:
    """The printout's lines with every number replaced by ``#``."""
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line)
            for line in text.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's launcher, 6 steps of reduced stablelm-12b, checkpointing
    into a fresh directory: (its stdout, the directory)."""
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *RESUME_ARGS,
         "--ckpt-dir", str(ckpt)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout, ckpt


def test_launcher_prints_jax_lines(jax_run, tmp_path, capsys):
    assert ttrain.main([*RESUME_ARGS, "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert _shape(out) == _shape(jax_run[0])
    assert [int(m.group(1)) for m in _STEP_LINE.finditer(out)] == \
        list(range(1, 7))
    assert CheckpointManager(str(tmp_path)).all_steps() == [4]


def test_launcher_resumes_a_jax_checkpoint(jax_run, capsys):
    jout, ckpt = jax_run
    assert CheckpointManager(str(ckpt)).all_steps() == [4]
    want = {int(m.group(1)): (float(m.group(2)), float(m.group(4)))
            for m in _STEP_LINE.finditer(jout)}
    assert sorted(want) == list(range(1, 7))
    assert ttrain.main(["--arch", "stablelm-12b", "--reduced", "--steps",
                        "6", "--resume", "--device", "cpu", "--log-every",
                        "1", "--ckpt-dir", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint @ step 4" in out
    got = {int(m.group(1)): (float(m.group(2)), float(m.group(4)))
           for m in _STEP_LINE.finditer(out)}
    assert sorted(got) == [5, 6]
    for step in (5, 6):
        (loss, gnorm), (want_loss, want_gnorm) = got[step], want[step]
        assert abs(loss - want_loss) <= LOSS_TOL, (step, got, want)
        assert abs(gnorm - want_gnorm) <= (
            GNORM_RTOL * want_gnorm + GNORM_PRINTED), (step, got, want)


def test_train_returns_the_run(tmp_path):
    args = ttrain.parse_args(["--arch", "granite-moe-1b-a400m", "--steps",
                              "3", "--batch", "4", "--seq-len", "8",
                              "--microbatches", "2", "--remat",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path), "--ckpt-every", "2"])
    run = ttrain.train(get_config("granite-moe-1b-a400m").reduced(), args)
    assert [s for s, *_ in run.log] == [1, 2, 3]
    assert int(run.state["opt"]["step"]) == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert all(np.isfinite(v) for _, *vals in run.log for v in vals)


def test_launcher_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "stablelm-12b", "--reduced", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


def test_launched_lm_holds_one_form_of_its_weights(tmp_path, monkeypatch):
    """The launcher's ``LM`` keeps no weights of its own (ROADMAP A19):
    its parameters are shapes on the meta device, the train state holds
    the only copy, and reading the module's own weights raises."""
    built = []

    class Recorded(LM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(ttrain, "LM", Recorded)
    args = ttrain.parse_args(["--arch", "stablelm-12b", "--steps", "2",
                              "--batch", "2", "--seq-len", "8", "--device",
                              "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = get_config("stablelm-12b").reduced()
    run = ttrain.train(cfg, args)
    (model,) = built
    assert not model.has_weights
    assert all(p.is_meta for p in model.parameters())
    assert all(t.device.type == "cpu" for _, t in key_leaves(run.state))
    with pytest.raises(RuntimeError, match="weights=False"):
        model.forward(torch.zeros((1, 4), dtype=torch.int32))
    # the stacked tree is every weight the module would have held
    full = LM(cfg, device="cpu")
    assert sum(t.numel() for _, t in key_leaves(run.state["params"])) == \
        sum(p.numel() for p in full.parameters())
