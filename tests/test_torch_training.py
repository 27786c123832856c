"""The port's training path (``repro_torch.training``, ``LM.loss``)
against the JAX package's.

Both packages run the reduced configs (2 layers, d 64, vocab 256) from
ONE set of weights: the JAX ``LM.init`` pytree, whose numpy leaves are
the port's train-state leaves as they are (the train state keeps JAX's
layout and leaf names).  Token inputs are numpy-seeded.

The JAX side of the model comparisons runs in a child process with
``XLA_FLAGS=--xla_allow_excess_precision=false`` (see
``tests/test_torch_lm.py``): XLA on the CPU otherwise skips bf16
roundings the JAX program writes and the port performs.  The child also
sets ``--xla_backend_optimization_level=0``, which halves its compile
time (to about 47 s on one core); the compiled programs compute the same
operations.  The pure-f32
functions (schedules, compression, the microbatch split, the decay mask)
are compared in this process.

Tolerances, each stated where it is used:
* ``LM.loss`` and a train step's loss: ``LOSS_TOL`` (absolute; the
  losses are about 5.5 and come from bf16 activations, where a value may
  round to the neighbouring bf16 in one package);
* ``grad_norm``: ``GNORM_RTOL`` relative;
* each gradient leaf, against JAX's from the same weights and batch:
  ``GRAD_RTOL`` in relative L2 norm, leaf by leaf.  The leaves' dtypes
  do not set this error: every gradient flows through bf16 activations
  in both packages, an f32 norm scale or RWKV mix as much as a bf16
  matrix (the readings: up to 1.12e-2 on rwkv6's f32 ``ffn.mix_k``,
  6.3e-3 on stablelm's bf16 ``embed``).  A gradient off by a factor of
  2, or of the wrong sign, on any one leaf is off by 0.5 or more.  A
  train step's first moment ``m``, ``(1 - b1)`` times its gradient
  scaled by the clip ``1 / grad_norm``, holds the step's gradients (at
  4 microbatches too: the strided split under capacity-dropping MoE,
  readings up to 2.4e-3) leaf by leaf within ``GRAD_RTOL + GNORM_RTOL``;
  the updated parameters cannot (Adam's first step moves each element
  by +-lr whatever its gradient's size);
* each updated parameter leaf: a bf16 leaf within one bf16 ulp of JAX's
  value at ``UPDATED_FRAC`` of its elements and within ``2 lr`` plus an
  ulp at all (an element whose gradient is near 0 may take the other
  sign of Adam's first step, ``m / sqrt(v) = ±1``); an f32 leaf within
  ``2 lr`` plus ``1e-6`` of its magnitude;
* ``adamw_update`` fed JAX's own gradients: every f32 result (``m``,
  ``v``, f32 parameters, ``lr``, ``grad_norm``) within 1 f32 ulp (XLA
  fuses ``b1 * m + (1 - b1) * g`` into a multiply-add under ``jit``),
  every bf16 parameter within 1 bf16 ulp (an f32 result one ulp apart
  may round to the other bf16 neighbour);
* ``schedule_lr``: within 1 f32 ulp (``cos`` and ``pow`` in f32 are
  torch's and XLA's own);
* compression: bit-identical;
* remat: bit-equal to no remat on the CPU (the recompute runs the same
  operations on the same values, and a stacked leaf's gradient is one
  ``stack`` of its layers' in either case).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.models import LM as JLM
from repro.models.layers import cross_entropy_loss as jce
from repro.training import compression as jcomp
from repro.training import optim as joptim
from repro.training.train_step import _split_microbatches as jsplit
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget_config
from repro_torch.core.tree import key_leaves, tree_leaves, tree_unflatten
from repro_torch.kernels import ops as kops
from repro_torch.models import LM as TLM
from repro_torch.models.layers import cross_entropy_loss as tce
from repro_torch.training import compression as tcomp
from repro_torch.training import optim as toptim
from repro_torch.training.train_step import _split_microbatches as tsplit
from repro_torch.training.train_step import (
    init_train_state,
    make_grad_fn,
    make_train_step,
    train_state,
)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ARCHS = ("stablelm-12b", "granite-moe-1b-a400m", "rwkv6-1.6b")
STEP_CASES = (("granite-moe-1b-a400m", 1), ("granite-moe-1b-a400m", 4))
ADAMW_ARCH = "granite-moe-1b-a400m"
SCHEDULES = ("constant", "cosine", "wsd")
B, T = 4, 16
LOSS_TOL = 2e-3
GNORM_RTOL = 1e-2
GRAD_RTOL = 2e-2
UPDATED_FRAC = 0.999
# Three steps through warmup, the cosine and the WSD decay tail (steps
# 1-3; the WSD tail starts after step 2.5), at an lr that moves bf16
# weights.
ADAMW_CFG = dict(lr=1e-2, warmup_steps=1, total_steps=4, stable_frac=0.5)
ADAMW_STEPS = 3
# grad_clip 1e9 leaves the gradients unscaled in both packages; at 1.0
# (the default) granite's norm is clipped, and each package's norm is its
# own sum of squares, summed in its own order (up to NORM_ULPS apart).
# The clip scale carries those ulps into every scaled gradient, with a
# rounding each for the scale, the product and the moment: clipped, m is
# held within 2 * NORM_ULPS and v (which squares the gradient) within
# 4 * NORM_ULPS.
CLIPS = (1e9, 1.0)
NORM_ULPS = 8
P_ULPS = 4


def _batch(arch: str) -> dict:
    rng = np.random.default_rng(len(arch))
    vocab = jget_config(arch).reduced().vocab_size
    tokens = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return {"tokens": tokens, "labels": tokens}


def _embeds_batch(arch: str) -> dict:
    """``_batch(arch)`` fed as embeddings at shifted positions: frame
    embeddings ``[B, T, d_model]`` f32 in place of the tokens, and
    positions ``3 .. T + 2``."""
    rng = np.random.default_rng(len(arch) + 100)
    d = jget_config(arch).reduced().d_model
    return {"embeds": (rng.standard_normal((B, T, d)) * 0.5).astype(
                np.float32),
            "positions": np.broadcast_to(np.arange(3, T + 3, dtype=np.int32),
                                         (B, T)).copy(),
            "labels": _batch(arch)["labels"]}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    """The JAX weights of ``arch`` (drawn in the child only)."""
    return JLM(jget_config(arch).reduced()).init(jax.random.PRNGKey(0))


def _flat(tree, prefix: str) -> dict:
    """``{prefix + keystr: f32 (or int) numpy}`` of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, a in flat:
        a = np.asarray(a)
        out[prefix + jax.tree_util.keystr(path)] = (
            a.astype(np.float32) if jnp.issubdtype(a.dtype, jnp.floating)
            else a)
    return out


# ---------------------------------------------------------------------------
# the JAX side, run in a child process that rounds every bf16 op
# ---------------------------------------------------------------------------

def _write_jax_refs(path: str) -> None:
    out = {}
    for arch in LOSS_ARCHS:
        jm, params = JLM(jget_config(arch).reduced()), _jax_params(arch)
        out.update(_flat(params, f"init/{arch}"))
        batch = jax.tree.map(jnp.asarray, _batch(arch))
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
        out.update(_flat(grads, f"grads/{arch}"))
        out[f"loss/{arch}"] = np.asarray(loss)
        if arch == "stablelm-12b":
            out[f"loss_embeds/{arch}"] = np.asarray(jax.jit(jm.loss)(
                params, jax.tree.map(jnp.asarray, _embeds_batch(arch))))
        if arch == ADAMW_ARCH:
            adamw_grads = grads
    for arch, micro in STEP_CASES:
        params = _jax_params(arch)
        state = {"params": params, "opt": joptim.adamw_init(params)}
        step = jax.jit(jmake_train_step(
            JLM(jget_config(arch).reduced()), joptim.AdamWConfig(),
            num_microbatches=micro, remat=False))
        new, metrics = step(state, jax.tree.map(jnp.asarray, _batch(arch)))
        key = f"step/{arch}/{micro}/"
        for name in ("loss", "lr", "grad_norm"):
            out[key + name] = np.asarray(metrics[name])
        out.update(_flat(new["params"], key + "params"))
        out.update(_flat(new["opt"]["m"], key + "m"))
    params = _jax_params(ADAMW_ARCH)
    grads = adamw_grads        # AdamW runs on JAX's own gradients
    for sched in SCHEDULES:
        # one compile a schedule: the clip is an argument
        update = jax.jit(lambda p, g, o, clip, sched=sched:
                         joptim.adamw_update(joptim.AdamWConfig(
                             schedule=sched, grad_clip=clip, **ADAMW_CFG),
                             p, g, o))
        for clip in CLIPS:
            p, opt = params, joptim.adamw_init(params)
            for i in range(ADAMW_STEPS):
                p, opt, metrics = update(p, grads, opt, jnp.float32(clip))
                key = f"adamw/{sched}/{clip}/{i}/"
                out.update(_flat(p, key + "params"))
                out.update(_flat({"m": opt["m"], "v": opt["v"]}, key))
                out[key + "lr"] = np.asarray(metrics["lr"])
                out[key + "grad_norm"] = np.asarray(metrics["grad_norm"])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_refs") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false "
                         "--xla_backend_optimization_level=0")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_training as t; t._write_jax_refs(sys.argv[2])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


_SETUPS: dict = {}


def _setup(arch: str, refs) -> dict:
    """The port's model and train-state params of ``arch`` on JAX's
    weights (the child's, laid out as JAX's tree)."""
    if arch not in _SETUPS:
        model = TLM(tget_config(arch).reduced(), device="cpu")
        like = model.stacked_params()      # JAX's layout, names and dtypes
        _SETUPS[arch] = dict(
            model=model, params=_tree_from(refs, f"init/{arch}", like),
            batch={k: torch.from_numpy(v) for k, v in _batch(arch).items()})
    return _SETUPS[arch]


def _tree_from(refs, prefix: str, like) -> dict:
    """A tree of ``like``'s structure and dtypes from the refs' leaves
    under ``prefix``."""
    return tree_unflatten(like, [
        torch.from_numpy(refs[prefix + path].copy()).to(leaf.dtype)
        for path, leaf in key_leaves(like)])


def _ordered(t: torch.Tensor) -> np.ndarray:
    """Integers whose differences count ulps between floats of one
    dtype (sign-magnitude bits mapped to a monotone order)."""
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    bits = t.float().numpy().view(np.int32).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _ulp(scale: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at each magnitude of ``scale`` (f32)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    e = torch.floor(torch.log2(torch.clamp(scale, min=2.0**-126)))
    return torch.exp2(e - mant)


def _max_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    return int(np.max(np.abs(_ordered(got) - _ordered(want.to(got.dtype))),
                      initial=0))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_entropy_loss_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 3] = -1
    for lab in (labels, np.full_like(labels, -1)):
        want = float(jce(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(tce(torch.from_numpy(logits), torch.from_numpy(lab)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    assert float(tce(torch.from_numpy(logits),
                     torch.from_numpy(np.full_like(labels, -1)))) == 0.0


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_matches_jax(refs, arch):
    s = _setup(arch, refs)
    got = s["model"].loss(s["batch"], params=s["params"])
    assert got.dtype == torch.float32 and got.ndim == 0
    want = float(refs[f"loss/{arch}"])
    assert abs(float(got) - want) <= LOSS_TOL, (float(got), want)


def test_lm_loss_refuses_embeds_and_positions(refs):
    """``embeds`` and ``positions`` in the batch, against JAX's loss on
    the same batch (the embedding table is then not read)."""
    arch = "stablelm-12b"
    s = _setup(arch, refs)
    batch = {k: torch.from_numpy(v) for k, v in _embeds_batch(arch).items()}
    got = s["model"].loss(batch, params=s["params"])
    want = float(refs[f"loss_embeds/{arch}"])
    assert abs(float(got) - want) <= LOSS_TOL, (float(got), want)
    assert abs(want - float(refs[f"loss/{arch}"])) > 10 * LOSS_TOL


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,micro", STEP_CASES)
def test_train_step_matches_jax(refs, arch, micro):
    s = _setup(arch, refs)
    step = make_train_step(s["model"], toptim.AdamWConfig(),
                           num_microbatches=micro, remat=False)
    state = train_state(s["params"])
    new, metrics = step(state, s["batch"])
    key = f"step/{arch}/{micro}/"
    assert abs(float(metrics["loss"]) - float(refs[key + "loss"])) \
        <= LOSS_TOL
    assert float(metrics["lr"]) == float(refs[key + "lr"])
    want_norm = float(refs[key + "grad_norm"])
    assert abs(float(metrics["grad_norm"]) - want_norm) \
        <= GNORM_RTOL * want_norm
    assert int(new["opt"]["step"]) == 1
    # The first moment is (1 - b1) times the step's gradient (f32
    # accumulated over the microbatches) scaled by its clip, 1/grad_norm.
    _hold_leaves(dict(key_leaves(new["opt"]["m"])), refs, key + "m",
                 s["params"], GRAD_RTOL + GNORM_RTOL)
    lr = float(metrics["lr"])
    for path, leaf in key_leaves(new["params"]):
        want = torch.from_numpy(refs[key + "params" + path].copy())
        got = leaf.float()
        err = (got - want).abs()
        if leaf.dtype == torch.bfloat16:
            ulp = want.abs() * 2.0**-7 + 1e-30
            assert float((err <= ulp).float().mean()) >= UPDATED_FRAC, path
            assert bool((err <= 2 * lr + ulp).all()), path
        else:
            assert bool((err <= 2 * lr + 1e-6 * want.abs()).all()), \
                (path, float(err.max()))
    # the state given is not modified
    assert int(state["opt"]["step"]) == 0
    assert all(bool((v == 0).all()) for v in tree_leaves(state["opt"]["m"]))


def _hold_leaves(got: dict, refs, key: str, like, rtol: float) -> None:
    """Each leaf of ``got`` (``{keystr: tensor}``, ``like``'s paths)
    within ``rtol`` of JAX's ``refs[key + path]`` in relative L2 norm."""
    assert sorted(got) == sorted(
        k[len(key):] for k in refs if k.startswith(key + "["))
    for path, _ in key_leaves(like):
        want = torch.from_numpy(refs[key + path].copy())
        den = float(want.norm())
        assert den > 0, path
        rel = float((got[path].float() - want).norm()) / den
        assert rel <= rtol, (path, rel)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_gradients_match_jax(refs, arch):
    """The loss's gradient against every leaf, against JAX's on the same
    weights and batch."""
    s = _setup(arch, refs)
    loss, grads = make_grad_fn(s["model"], remat=False)(s["params"],
                                                        s["batch"])
    assert abs(float(loss) - float(refs[f"loss/{arch}"])) <= LOSS_TOL
    got = dict(key_leaves(grads))
    for path, leaf in key_leaves(s["params"]):
        assert got[path].dtype == leaf.dtype, path
    _hold_leaves(got, refs, f"grads/{arch}", s["params"], GRAD_RTOL)


def test_grad_fn_refuses_an_unread_leaf(refs):
    """A leaf the loss does not read raises: a layer cut off from the
    loss must not pass as a zero gradient, on which card and CPU would
    agree.  Only the embedding table under an ``embeds`` batch takes
    zeros, as under ``jax.grad``."""
    arch = "stablelm-12b"
    s = _setup(arch, refs)
    grad_fn = make_grad_fn(s["model"], remat=False)
    embeds = {k: torch.from_numpy(v) for k, v in _embeds_batch(arch).items()}
    orphan = dict(s["params"], orphan=torch.zeros(3))
    for batch in (s["batch"], embeds):
        with pytest.raises(RuntimeError, match="orphan"):
            grad_fn(orphan, batch)
    _, grads = grad_fn(s["params"], embeds)
    assert not bool(grads["embed"].any())
    assert bool(grads["head"].any())


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("sched", SCHEDULES)
def test_adamw_update_matches_jax(refs, sched, clip):
    """Each of three steps from JAX's state of the step before, on JAX's
    gradients."""
    s = _setup(ADAMW_ARCH, refs)
    grads = _tree_from(refs, f"grads/{ADAMW_ARCH}", s["params"])
    cfg = toptim.AdamWConfig(schedule=sched, grad_clip=clip, **ADAMW_CFG)
    clipped = clip == 1.0                    # granite's norm is above 1
    p, opt = s["params"], toptim.adamw_init(s["params"])
    for i in range(ADAMW_STEPS):
        key = f"adamw/{sched}/{clip}/{i}/"
        new_p, new_opt, metrics = toptim.adamw_update(cfg, p, grads, opt)
        assert _max_ulps(metrics["lr"], torch.from_numpy(
            np.asarray(refs[key + "lr"]))) <= 1
        assert _max_ulps(metrics["grad_norm"], torch.from_numpy(
            np.asarray(refs[key + "grad_norm"]))) <= NORM_ULPS
        assert int(new_opt["step"]) == i + 1
        for name, ulps in (("m", 2 * NORM_ULPS if clipped else 1),
                           ("v", 4 * NORM_ULPS if clipped else 1)):
            for path, leaf in key_leaves(new_opt[name]):
                want = torch.from_numpy(refs[f"{key}['{name}']{path}"].copy())
                assert _max_ulps(leaf, want) <= ulps, (i, name, path)
        want_p = _tree_from(refs, key + "params", p)
        for (path, leaf), old, want in zip(key_leaves(new_p), tree_leaves(p),
                                           tree_leaves(want_p)):
            scale = torch.maximum(old.float().abs(),
                                  (want.float() - old.float()).abs())
            ulp = _ulp(scale, leaf.dtype)
            err = (leaf.float() - want.float()).abs()
            assert bool((err <= P_ULPS * ulp).all()), (i, path)
        # the next step starts from JAX's state
        p = want_p
        opt = {"m": _tree_from(refs, key + "['m']", opt["m"]),
               "v": _tree_from(refs, key + "['v']", opt["v"]),
               "step": new_opt["step"]}


def test_schedule_lr_matches_jax():
    steps = np.arange(101, dtype=np.int32)
    for sched in SCHEDULES:
        for kw in (dict(warmup_steps=10, total_steps=100, stable_frac=0.8),
                   dict(warmup_steps=0, total_steps=60)):
            jcfg = joptim.AdamWConfig(lr=3e-4, schedule=sched, **kw)
            want = np.asarray(jax.jit(
                lambda s, c=jcfg: joptim.schedule_lr(c, s))(steps))
            got = toptim.schedule_lr(toptim.AdamWConfig(
                lr=3e-4, schedule=sched, **kw), torch.from_numpy(steps))
            assert got.dtype == torch.float32
            err = np.abs(got.numpy() - want).max()
            assert err <= 3e-4 * 2.0**-22, (sched, kw, err)


def _decay_mask(tree) -> dict:
    """``{keystr: decayed}`` of every leaf, as the port's update sees
    it."""
    return {path: toptim._decay_mask(path) for path, _ in key_leaves(tree)}


def _jax_shapes(jcfg):
    return jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))


def _built_configs():
    """The reduced configs the port's ``LM`` builds."""
    out = []
    for name in list_configs():
        try:
            out.append((name, TLM(tget_config(name).reduced(),
                                  device="cpu")))
        except NotImplementedError:
            pass
    return out


def test_decay_mask_and_leaves_match_jax_for_every_built_config():
    built = _built_configs()
    assert {"stablelm-12b", "granite-moe-1b-a400m", "rwkv6-1.6b",
            "jamba-1.5-large-398b"} <= {name for name, _ in built}
    for name, model in built:
        shapes = _jax_shapes(jget_config(name).reduced())
        flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
        want = {jax.tree_util.keystr(p): joptim._decay_mask(
            jax.tree_util.keystr(p)) for p, _ in flat}
        tree = model.stacked_params()
        assert _decay_mask(tree) == want, name
        for (path, leaf), (_, jleaf) in zip(key_leaves(tree), flat):
            assert tuple(leaf.shape) == jleaf.shape, (name, path)
            assert str(leaf.dtype).split(".")[1] == jleaf.dtype.name, path
    # the reference's property: "mix" matches every ['mixer'] path
    mask = _decay_mask(dict(built)["granite-moe-1b-a400m"].stacked_params())
    assert not any(v for p, v in mask.items() if "['mixer']" in p)
    assert mask["['embed']"] and any(
        v for p, v in mask.items() if "['experts']" in p)


# ---------------------------------------------------------------------------
# remat, microbatches, compression, kernels under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "rwkv6-1.6b"))
def test_remat_is_bit_equal_to_no_remat(refs, arch):
    s = _setup(arch, refs)
    out = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_()
                  for t in tree_leaves(s["params"])]
        loss = s["model"].loss(s["batch"], remat=remat, params=tree_unflatten(
            s["params"], leaves))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)


def test_strided_microbatch_split_matches_jax():
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 99, (8, 5)).astype(np.int32),
             "labels": rng.integers(0, 99, (8, 5)).astype(np.int32),
             "positions": rng.integers(0, 99, (3, 8, 5)).astype(np.int32)}
    for n in (1, 2, 4, 8):
        want = jsplit(jax.tree.map(jnp.asarray, batch), n)
        got = tsplit({k: torch.from_numpy(v) for k, v in batch.items()}, n)
        for name in batch:
            assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    # element (m, k) is global row m + n*k
    assert np.array_equal(got["tokens"][3][0].numpy(), batch["tokens"][3])
    with pytest.raises(ValueError):
        tsplit({"tokens": torch.zeros((6, 2))}, 4)


def test_compression_bit_identical_to_jax():
    rng = np.random.default_rng(7)
    for i in range(6):
        x = (rng.standard_normal((257,)) * 10.0 ** rng.integers(-6, 3)
             ).astype(np.float32)
        x[:3] = (0.0, x[3] * 0.5, -x[4])
        e = (rng.standard_normal((257,)) * 1e-3).astype(np.float32)
        tx, te = torch.from_numpy(x), torch.from_numpy(e)
        for fn in (jax.jit,):
            q, s = fn(jcomp.quantize_int8)(jnp.asarray(x))
            tq, ts = tcomp.quantize_int8(tx)
            assert np.array_equal(tq.numpy(), np.asarray(q))
            assert tq.dtype == torch.int8 and ts.dtype == torch.float32
            assert ts.numpy().view(np.int32) == np.asarray(s).view(np.int32)
            deq, res = fn(jcomp.compress_residual)(jnp.asarray(x))
            tdeq, tres = tcomp.compress_residual(tx)
            assert np.array_equal(tdeq.numpy().view(np.int32),
                                  np.asarray(deq).view(np.int32))
            assert np.array_equal(tres.numpy().view(np.int32),
                                  np.asarray(res).view(np.int32))
            comp = fn(jcomp.apply_error_feedback)({"w": jnp.asarray(x)},
                                                  {"w": jnp.asarray(e)})
            tcomp_ = tcomp.apply_error_feedback({"w": tx}, {"w": te})
            assert np.array_equal(tcomp_["w"].numpy().view(np.int32),
                                  np.asarray(comp["w"]).view(np.int32))
    ef = tcomp.error_feedback_init({"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert ef["a"].dtype == torch.float32 and not ef["a"].any()


def test_compressed_psum_in_one_process_group():
    import torch.distributed as dist

    from repro_torch.training.compression import compressed_psum_gradients

    grads = {"w": torch.arange(8, dtype=torch.float32) / 7.0,
             "b": {"c": torch.tensor([-3.0, 0.25])}}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        out = compressed_psum_gradients(grads)
    finally:
        dist.destroy_process_group()
    # one rank: the requantized leaf itself, within the int8 error bound
    assert float((out["w"] - grads["w"]).abs().max()) < 1e-2
    for path, leaf in key_leaves(grads):
        want, _ = tcomp.compress_residual(leaf)
        got = dict(key_leaves(out))[path]
        assert torch.equal(got, want), path


def test_kernel_wrappers_refuse_autograd():
    gen = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(*shape, generator=gen)
    calls = {
        "flash_attention": lambda g: kops.flash_attention(
            r(1, 8, 2, 16).requires_grad_(g), r(1, 8, 1, 16), r(1, 8, 1, 16)),
        "decode_attention": lambda g: kops.decode_attention(
            r(1, 2, 16).requires_grad_(g), r(1, 8, 1, 16), r(1, 8, 1, 16),
            torch.tensor([5], dtype=torch.int32)),
        "rwkv6_scan": lambda g: kops.rwkv6_scan(
            r(1, 2, 8, 16).requires_grad_(g), r(1, 2, 8, 16), r(1, 2, 8, 16),
            -torch.rand(1, 2, 8, 16, generator=gen), r(2, 16)),
        "mamba_scan": lambda g: kops.mamba_scan(
            r(1, 8, 6).requires_grad_(g), torch.rand(1, 8, 6, generator=gen),
            r(1, 8, 4), r(1, 8, 4), -torch.rand(6, 4, generator=gen)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(True)
        with torch.no_grad():
            out = call(True)                 # no graph: the plain version
        assert not (out[0] if isinstance(out, tuple) else out).requires_grad
        call(False)
    # through the model: a pallas LM's loss against trainable leaves
    cfg = tget_config("stablelm-12b").reduced()
    model = TLM(cfg, attn_impl="pallas", device="cpu").init(0)
    tree = model.stacked_params()
    leaves = [t.requires_grad_() for t in tree_leaves(tree)]
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        model.loss({"tokens": tokens, "labels": tokens},
                   params=tree_unflatten(tree, leaves))


def test_serving_unchanged_after_a_train_step():
    """Training reads the weights of its own train state: after one is
    drawn and a step taken, a served prompt (``repro_torch.serving.engine``) and a
    ``forward`` under the kernels give the same values, and nothing
    carries a graph."""
    from repro_torch.serving.engine import ServingEngine

    cfg = tget_config("stablelm-12b").reduced()
    model = TLM(cfg, attn_impl="pallas", device="cpu").init(0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        "stablelm-12b").items()}

    def served():
        eng = ServingEngine(model, max_slots=2, max_len=64)
        eng.submit(0, [3, 1, 4, 1, 5, 9], 6, at=0.0)
        eng.schedule_decode_grid(1.0, 40.0)
        eng.run()
        cache = [t for t in tree_leaves(eng.cache)]
        assert not any(t.requires_grad for t in cache)
        return eng.requests[0].output, cache

    def outputs():
        logits, aux = model(batch["tokens"])
        assert not logits.requires_grad and not aux.requires_grad
        return logits, served()

    before = outputs()
    model.attn_impl = "blockwise"          # the kernels have no backward
    # another seed's weights: drawing them leaves the model's own alone
    state = init_train_state(model, 1)
    new, metrics = make_train_step(model, toptim.AdamWConfig(lr=1e-2))(
        state, batch)
    assert metrics["loss"].isfinite() and not metrics["loss"].requires_grad
    assert not torch.equal(new["params"]["embed"], state["params"]["embed"])
    model.attn_impl = "pallas"
    after = outputs()
    assert torch.equal(before[0], after[0])
    assert before[1][0] == after[1][0] and len(after[1][0]) == 6
    assert all(torch.equal(a, b) for a, b in zip(before[1][1], after[1][1]))
    assert not any(p.requires_grad for p in model.parameters())
