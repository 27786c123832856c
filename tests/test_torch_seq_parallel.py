"""The LM on a real mesh of 4 gloo processes on the CPU, with
the sharding rules, the activation anchors and ``seq_parallel=True``,
against the same LM without a mesh and against JAX's LM on the same
mesh.

Each rank builds reduced stablelm-12b (dense, on a (2, 2) mesh; MoE
granite on a (1, 4) mesh: ``tests/test_torch_expert_parallel.py``) in
f32 from one seed, runs the
model without a mesh (the reference), then with its weights placed by
``sharding.distribute_lm``, its caches, batches and train state by the
rules, inside ``sharding.anchored(mesh)``: a forward, a prefill into a
longer cache, two decode steps (the cache's sequence dim is sharded
over ``model``, so the plain decode takes the partial-softmax route),
and a microbatched, rematerialized train step.  Rank 0 gathers every
output with ``full_tensor()`` and writes the largest differences.

Tolerance: the ranks sum f32 products in other orders (row-parallel
partial sums, the partial softmax): logits within 1e-4 of the largest
reference logit, caches within 1e-5 abs, the loss and grad norm within
1e-5 relative, and AdamW's first moments (0.1 of the gradient, leaf by
leaf; the parameters move by +-lr whatever the gradient) within 1e-4
relative L2.

JAX's reference on the same mesh: a JAX child process on 4 forced host
devices runs JAX's ``LM(seq_parallel=True)`` with the same weights on a
mesh of the same shape under JAX's rules (``param_shardings``,
``cache_shardings``, ``state_shardings``, ``batch_shardings``,
``set_batch_axes``; excess precision off), beside the ranks.  In f32
(JAX's weights cast) the meshed port's forward and prefill logits are
held to JAX's within 1e-4 of JAX's largest logit, its train step's loss
and grad norm within 1e-5 relative: f32 sums in other orders, as above.
JAX keeps its caches in bf16 whatever the weights, so the decode, with
its partial softmax over the sequence-sharded cache, is held in bf16,
the weights' own dtype: each step's logits within ``LOGIT_TOL`` (the
one-device tolerance of ``tests/test_torch_lm.py``) plus the distance
from JAX's meshed logits to its own on one device, since XLA's
partitioning reorders the f32 sums under the bf16 roundings too (0.023
and 0.034 for stablelm's two steps).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# arch -> (B, T, max_len, model axis): stablelm on a (2, 2) mesh;
# granite's 2 x 512 tokens fill one 1024-token dispatch group, its experts
# split over a (1, 4) mesh (expert parallelism).
CASES = {"stablelm-12b": (4, 32, 48, 2),
         "granite-moe-1b-a400m": (2, 512, 528, 4)}
LOGIT_TOL = 3e-2
DECODE_STEPS = 2


def _inputs(arch: str):
    """The reduced config, its prompts [B, T] and two decode steps'
    tokens [2, B, 1] (int32), from one seed."""
    import torch

    from repro_torch.configs import get_config

    B, T, _, _ = CASES[arch]
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, B, 1),
                          generator=gen, dtype=torch.int32)
    return cfg, tokens, steps


def _write_weights(arch: str, path: str) -> None:
    """The port's ``LM.init(0)`` weights in JAX's layout, one array a
    leaf by its ``keystr`` path (bf16 as its 16-bit patterns)."""
    import numpy as np
    import torch

    from repro_torch.core.tree import key_leaves
    from repro_torch.models import LM

    cfg, _, _ = _inputs(arch)
    tree = LM(cfg, device="cpu").init(0).stacked_params()
    np.savez(path, **{
        p: (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())
        for p, t in key_leaves(tree)})


def _write_jax_meshed(arch: str, weights: str, path: str) -> None:
    """JAX's ``LM(seq_parallel=True)`` on a mesh of ``CASES[arch]``'s
    shape over 4 host devices, with the weights of ``weights``: in f32
    (the weights cast), the forward's logits, the prefill's, and a
    microbatched, rematerialized train step's loss and grad norm; in
    bf16, two decode steps' logits after a prefill, on the mesh and on
    one device."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import get_config
    from repro.launch import sharding as jsh
    from repro.models.model import LM
    from repro.training.optim import AdamWConfig, adamw_init
    from repro.training.train_step import make_train_step

    B, T, MAX_LEN, model_axis = CASES[arch]
    _, tokens, steps = _inputs(arch)
    tokens, steps = jnp.asarray(tokens.numpy()), jnp.asarray(steps.numpy())
    model = LM(get_config(arch).reduced(), seq_parallel=True)
    drawn = np.load(weights)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(drawn[jax.tree_util.keystr(p)].view(leaf.dtype))
        for p, leaf in flat])
    prefill = jax.jit(functools.partial(model.prefill, max_len=MAX_LEN))
    decode = jax.jit(model.decode_step)
    # jax.make_mesh's explicit axes refuse the model's sharding
    # constraints under jax 0.9; jax.sharding.Mesh's are automatic
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()).reshape(WORLD // model_axis, model_axis),
        ("data", "model"))
    rows = NamedSharding(mesh, PartitionSpec(("data",), None))
    out = {}

    def decodes(params, cache, put, key):
        for i, tok in enumerate(steps):
            out[f"{key}{i}"], cache = decode(params, cache, put(tok))

    jsh.set_batch_axes(("data",))
    try:
        with mesh:
            toks = jax.device_put(tokens, rows)
            p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
            p32 = jax.device_put(p32, jsh.param_shardings(mesh, p32))
            out["f32/forward"] = jax.jit(model.forward)(p32, toks)[0]
            out["f32/prefill"] = prefill(p32, toks)[0]
            state = {"params": p32, "opt": adamw_init(p32)}
            batch = {"tokens": tokens, "labels": tokens}
            state = jax.device_put(state, jsh.state_shardings(mesh, state))
            batch = jax.device_put(batch, jsh.batch_shardings(mesh, batch))
            _, metrics = jax.jit(make_train_step(
                model, AdamWConfig(), num_microbatches=2, remat=True))(
                    state, batch)
            out["f32/loss"] = metrics["loss"]
            out["f32/grad_norm"] = metrics["grad_norm"]
            p16 = jax.device_put(params, jsh.param_shardings(mesh, params))
            cache = prefill(p16, toks)[1]
            cache = jax.device_put(cache, jsh.cache_shardings(mesh, cache,
                                                              batch=B))
            decodes(p16, cache, lambda t: jax.device_put(t, rows),
                    "bf16/decode")
    finally:
        jsh.set_batch_axes(None)
    # bf16 on one device: how far XLA's own partitioning moves JAX's
    # meshed decode logits
    one = jax.device_put(params, jax.devices()[0])
    decodes(one, prefill(one, tokens)[1], lambda t: t, "one/decode")
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})


def _rank(rank: int, port: int, path: str, arch: str) -> None:
    """One rank: the reference and the meshed runs, errors to ``path``;
    the meshed run's outputs that JAX's are held to, and a bf16 prefill
    and decode on the mesh, to ``path`` + ``.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.tree import key_leaves
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM, shards
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_step import make_train_step, train_state

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        B, T, MAX_LEN, model_axis = CASES[arch]
        cfg, tokens, steps = _inputs(arch)
        ref = LM(cfg, device="cpu").init(0)
        bf16 = {k: v.clone() for k, v in ref.state_dict().items()}
        ref.float()
        batch = {"tokens": tokens, "labels": tokens}

        def run(model, mesh, tree):
            out = {}

            def put(x, spec):
                return x if mesh is None else sh.distribute(x, mesh, spec)

            with sh.anchored(mesh):
                toks = put(tokens, sh.P(("data",), None))
                out["forward"] = model.forward(toks)[0]
                logits, cache = model.prefill(toks, max_len=MAX_LEN)
                out["prefill"] = logits
                for i, tok in enumerate(steps):
                    logits, cache = model.decode_step(
                        cache, put(tok, sh.P(("data",), None)))
                    out[f"decode{i}"] = logits
                out["cache"] = cache
                state = train_state(tree)
                b = batch
                if mesh is not None:
                    state = sh.distribute(state, mesh,
                                          sh.state_specs(mesh, state))
                    b = sh.distribute(batch, mesh,
                                      sh.batch_specs(mesh, batch))
                step = make_train_step(model, AdamWConfig(),
                                       num_microbatches=2, remat=True)
                new, metrics = step(state, b)
                out["m"] = new["opt"]["m"]
                out["loss"] = metrics["loss"]
                out["grad_norm"] = metrics["grad_norm"]
            return out

        # the reference on rank 0 alone, which compares
        want = run(ref, None, ref.stacked_params()) if rank == 0 else None
        mesh = make_host_mesh(model_axis, device="cpu")
        model = LM(cfg, device="cpu", seq_parallel=True)
        model.load_state_dict(ref.state_dict())
        model.float()
        got = run(sh.distribute_lm(model, mesh), mesh, ref.stacked_params())
        seq_sharded = bool(shards.sharded_over(
            got["cache"]["stages"][0]["l0"]["k"], 2))

        def full(x):
            return x.full_tensor() if isinstance(x, sh.DTensor) else x

        # every rank takes part in the gathers; rank 0 compares
        got = {k: [full(t) for _, t in key_leaves(v)]
               if isinstance(v, dict) else full(v) for k, v in got.items()}
        jax_side = {f"f32/{k}": got[k].detach().numpy()
                    for k in ("forward", "prefill", "loss", "grad_norm")}
        # a prefill and two decode steps in bf16, the weights' own dtype
        model = LM(cfg, device="cpu", seq_parallel=True)
        model.load_state_dict(bf16)
        sh.distribute_lm(model, mesh)
        with sh.anchored(mesh):
            rows = sh.P(("data",), None)
            cache = model.prefill(sh.distribute(tokens, mesh, rows),
                                  max_len=MAX_LEN)[1]
            for i, tok in enumerate(steps):
                logits, cache = model.decode_step(
                    cache, sh.distribute(tok, mesh, rows))
                jax_side[f"bf16/decode{i}"] = full(logits).float().numpy()
        if rank != 0:
            return
        np.savez(path + ".npz", **jax_side)
        errs = {}
        scale = float(want["forward"].abs().max())
        for k in ("forward", "prefill", "decode0", "decode1"):
            errs[k] = float((full(got[k]) - want[k]).abs().max()) / scale
        errs["cache"] = max(
            float((g - w).float().abs().max())
            for g, (_, w) in zip(got["cache"], key_leaves(want["cache"])))
        for k in ("loss", "grad_norm"):
            errs[k] = abs(float(full(got[k])) - float(want[k])) / abs(
                float(want[k]))
        errs["m"] = max(
            float(torch.linalg.vector_norm(g - w)
                  / max(float(torch.linalg.vector_norm(w)), 1e-30))
            for g, (_, w) in zip(got["m"], key_leaves(want["m"])))
        errs["seq_sharded_cache"] = seq_sharded
        with open(path, "w") as f:
            json.dump(errs, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(arch: str, tmp_path_factory) -> dict:
    """``_rank`` of ``arch`` in 4 processes and, beside them, JAX on the
    same mesh in a child process of its own (4 forced host devices);
    rank 0's errors, with the bf16 meshed run's against JAX's under
    ``jax/``."""
    import numpy as np

    tmp = tmp_path_factory.mktemp("mesh")
    path, weights, jax_out = (str(tmp / "errors.json"),
                              str(tmp / "weights.npz"), str(tmp / "jax.npz"))
    _write_weights(arch, weights)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                             "--xla_allow_excess_precision=false "
                             "--xla_backend_optimization_level=0")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_seq_parallel as t; "
            "t._rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], "
            "sys.argv[5])")
    jax_code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import test_torch_seq_parallel as t; "
                "t._write_jax_meshed(sys.argv[2], sys.argv[3], sys.argv[4])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT / "tests"), str(r), str(port),
         path, arch], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", jax_code, str(ROOT / "tests"), arch, weights,
         jax_out], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    with open(path) as f:
        errors = json.load(f)
    got, want = np.load(path + ".npz"), np.load(jax_out)

    def diff(a, b):
        return float(np.max(np.abs(a.reshape(b.shape) - b)))

    scale = float(np.max(np.abs(want["f32/forward"])))
    for k in ("f32/forward", "f32/prefill"):
        errors[f"jax/{k}"] = diff(got[k], want[k]) / scale
    for k in ("f32/loss", "f32/grad_norm"):
        errors[f"jax/{k}"] = diff(got[k], want[k]) / abs(float(want[k]))
    for i in range(DECODE_STEPS):
        k = f"bf16/decode{i}"
        errors[f"jax/{k}"] = diff(got[k], want[k])
        errors[f"jax_gap/{k}"] = diff(want[f"one/decode{i}"], want[k])
    return errors
    return errors


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    return run_ranks("stablelm-12b", tmp_path_factory)


TOLERANCES = [
    ("forward", 1e-4), ("prefill", 1e-4), ("decode0", 1e-4),
    ("decode1", 1e-4), ("cache", 1e-5), ("loss", 1e-5),
    ("grad_norm", 1e-5), ("m", 1e-4)]


JAX_TOLERANCES = [
    ("jax/f32/forward", 1e-4), ("jax/f32/prefill", 1e-4),
    ("jax/f32/loss", 1e-5), ("jax/f32/grad_norm", 1e-5)] + [
    (f"jax/bf16/decode{i}", LOGIT_TOL) for i in range(DECODE_STEPS)]


def hold_to_jax(errors: dict, what: str, tol: float) -> None:
    """``errors[what]`` within ``tol``; a step's logits within ``tol``
    plus the distance from JAX's meshed logits to its own on one device
    (``jax_gap/``): XLA's partitioning reorders the f32 sums under the
    bf16 roundings, and moves JAX's decode logits by about as much as
    the port's own reordering moves its."""
    step = what.removeprefix("jax/")
    bound = tol + errors.get(f"jax_gap/{step}", 0.0)
    assert errors[what] <= bound, (what, errors[what], bound, errors)


@pytest.mark.parametrize("what,tol", TOLERANCES)
def test_meshed_lm_equals_the_lm_without_a_mesh(errors, what, tol):
    assert errors[what] <= tol, errors


@pytest.mark.parametrize("what,tol", JAX_TOLERANCES)
def test_meshed_lm_equals_jax_on_the_same_mesh(errors, what, tol):
    hold_to_jax(errors, what, tol)


def test_decode_cache_is_sequence_sharded(errors):
    """The decode cache takes the rules' layout, its sequence dim over
    ``model``, so the decode steps above ran the partial softmax."""
    assert errors["seq_sharded_cache"] is True
