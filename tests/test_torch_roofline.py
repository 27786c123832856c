"""The port's lowering specs, cost model and roofline
(``repro_torch.launch.specs``, ``graph_cost``, ``roofline``) against
analytic ground truth and JAX's (``repro.launch.specs``, ``hlo_cost``,
``roofline``).

``tests/test_roofline.py``'s cases carried over: dot FLOPs exact;
repetition multiplied through (the port's Python loops unroll, so
``cell_cost`` extends traces at one and two pattern units, and two and
three microbatches, to the cell: ``test_torch_cost_extension.py`` holds
that equal to the full trace of the same reduced cell); a slice of a stacked weight read, not the stack;
terms and dominance at H100 rates; MoE's active parameters.  Then the
FLOPs of reduced decode, prefill and train cells against JAX's
``analyze_hlo(...).flops`` of the same cells compiled on a one-device
host mesh (at ``xla_backend_optimization_level`` 0, which halves the
train cell's compile: it skips LLVM's passes, not XLA's HLO passes,
whose output the cost model reads).  The one difference is named and
computed: JAX's cost model prices each ``lax.cond`` at its costlier
branch, so it counts the two dots of every causally skipped KV block
of ``blockwise_attention`` (once in a prefill, four times in a remat
train step: forward, recompute, and the two products of each dot's
backward), which the port's Python ``if`` never runs.  Every full-size
cell builds on fake tensors.  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils._pytree import tree_leaves

import jax

import repro.launch.roofline as jroof
import repro.launch.sharding as jsharding
from repro.configs import base as jbase
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.specs import build_cell as jbuild_cell
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import roofline as troof
from repro_torch.launch.graph_cost import cell_cost, trace_cost
from repro_torch.launch.roofline import (
    HBM_BW,
    PEAK_BF16,
    PEAK_FLOPS,
    Roofline,
    analyze,
    model_flops_for,
)
from repro_torch.launch.specs import build_cell, pick_microbatches


def _fake(*shapes, dtype=torch.float32):
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=dtype) for s in shapes]


def test_dot_flops_exact():
    M, K, N = 64, 128, 32
    mode, (a, b) = _fake((M, K), (K, N))
    cost = trace_cost(lambda a, b: a @ b, a, b, fake_mode=mode)
    assert cost.flops == 2 * M * K * N
    assert cost.flops_by_dtype == {"float32": 2 * M * K * N}
    assert cost.mem_bytes == (M * K + K * N + M * N) * 4
    mode, (a, b) = _fake((3, M, K), (3, K, N), dtype=torch.bfloat16)
    cost = trace_cost(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b), a, b,
                      fake_mode=mode)
    assert cost.flops_by_dtype == {"bfloat16": 3 * 2 * M * K * N}


def test_loop_multiplies_body_flops():
    """The counterpart of ``test_scan_multiplies_body_flops``: a layer
    loop counts every iteration's product (a Python loop unrolls), and
    the traced count of a 12-layer stack is the 1-layer one's plus 11
    times the difference to the 2-layer one's, as ``cell_cost`` extends
    it."""
    M = 64

    def stack(L):
        mode, (w, x) = _fake((L, M, M), (M,))

        def f(w, x):
            for wi in w.unbind(0):
                x = torch.tanh(wi @ x)
            return x

        return trace_cost(f, w, x, fake_mode=mode)

    c12, c1, c2 = stack(12), stack(1), stack(2)
    assert c12.flops == 12 * 2 * M * M
    ext = c1 + (c2 - c1).scaled(11)
    assert (ext.flops, ext.mem_bytes) == (c12.flops, c12.mem_bytes)


def test_sliced_weight_reads_not_full_stack():
    """Memory model: each layer reads its own slice of the stacked
    [L, M, M] weight, so a sweep counts about L·M·M·4 bytes, not
    L·(L·M·M·4)."""
    M, L = 128, 16
    mode, (w, x) = _fake((L, M, M), (M,))

    def f(w, x):
        for wi in w.unbind(0):
            x = torch.tanh(wi @ x)
        return x

    cost = trace_cost(f, w, x, fake_mode=mode)
    stack_bytes = L * M * M * 4
    assert 0.8 * stack_bytes < cost.mem_bytes < 3 * stack_bytes


def test_gather_and_row_update_bytes():
    """A gather reads its result's rows of the table, an in-place row
    update moves its index and twice its rows, not the destination."""
    mode, (table, cache, rows) = _fake((1000, 64), (8, 512, 64), (8, 1, 64))
    with mode:
        ids = torch.zeros((4,), dtype=torch.int64)
        pos = torch.zeros((8,), dtype=torch.int64)
    got = trace_cost(lambda t, i: torch.nn.functional.embedding(i, t),
                     table, ids, fake_mode=mode)
    assert got.mem_bytes == 4 * 64 * 4 + 4 * 8 + 4 * 64 * 4

    with mode:
        ar = torch.arange(8)
    got = trace_cost(lambda c, p, r: c.index_put_((ar, p), r[:, 0]),
                     cache, pos, rows, fake_mode=mode)
    assert got.mem_bytes == 2 * 8 * 8 + 2 * (8 * 64 * 4)


def test_roofline_terms_and_dominance():
    r = Roofline(
        arch="a", shape="s", mesh="single", chips=1,
        flops_per_device=989e12,          # exactly 1 s of bf16 compute
        bytes_per_device=3.35e12 * 2,     # 2 s of memory
        collective_bytes_per_device=0.0,
        collective_detail={}, model_flops=989e12 * 0.5,
        memory_stats={})
    assert r.compute_seconds == pytest.approx(1.0)
    assert r.memory_seconds == pytest.approx(2.0)
    assert r.collective_seconds == 0.0
    assert r.dominant == "memory"
    assert r.mfu == pytest.approx(0.25)   # useful/(bound*peak*chips)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    # f32 products at the f32 rate
    r32 = dataclasses.replace(r, flops_by_dtype={"float32": 67e12 * 3,
                                                 "bfloat16": 989e12})
    assert r32.compute_seconds == pytest.approx(4.0)
    assert r32.dominant == "compute"
    assert r32.bound_seconds == r32.compute_seconds
    # collectives at the slowest link their group spans: a 16-rank
    # "model" group crosses two 8-card nodes (InfiniBand), an 8-rank one
    # stays on NVLink; "data" of (16, 16) strides across nodes
    pod = dataclasses.replace(
        r, collective_bytes_per_device=8 * 50e9,
        collective_by_group={"model": 3 * 50e9, "data": 5 * 50e9},
        mesh_shape=(16, 16), mesh_axes=("data", "model"))
    assert pod.collective_seconds == pytest.approx(8.0)
    assert pod.dominant == "collective"
    node = dataclasses.replace(pod, collective_by_group={"model": 450e9},
                               mesh_shape=(32, 8))
    assert node.collective_seconds == pytest.approx(1.0)


def test_h100_constants_only():
    """Every rate is an H100 datasheet rate: SXM5 80GB, 989 TFLOP/s
    dense bf16 and fp16, 67 TFLOP/s f32, 3.35 TB/s HBM3; NVLink 4, 900
    GB/s a card in an 8-card HGX H100 node, 450 each way; NDR
    InfiniBand, 400 Gb/s a port, one a card.  None is one of the TPU
    rates of JAX's roofline, but for one named coincidence: the
    InfiniBand rate, 50e9 B/s, equals JAX's ``ICI_BW``."""
    assert PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                          "float32": 67e12}
    assert PEAK_BF16 == 989e12 and HBM_BW == 3.35e12
    assert troof.LINK_BW == {"nvlink": 450e9, "infiniband": 400e9 / 8}
    assert troof.CARDS_PER_NODE == 8
    rates = {name: v for name, v in vars(troof).items()
             if isinstance(v, float)}
    for table in ("PEAK_FLOPS", "LINK_BW"):
        rates.update({f"{table}[{k!r}]": v
                      for k, v in getattr(troof, table).items()})
    tpu = {jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW}
    assert {name for name, v in rates.items() if v in tpu} == {
        "LINK_BW['infiniband']"}
    assert troof.LINK_BW["infiniband"] == jroof.ICI_BW


def test_model_flops_moe_uses_active_params():
    dense = get_config("stablelm-12b")
    moe = get_config("granite-moe-1b-a400m")
    assert model_flops_for(dense, "train", 100, 4096) == pytest.approx(
        6 * dense.param_count() * 100)
    assert model_flops_for(moe, "train", 100, 4096) < \
        6 * moe.param_count() * 100  # active < total


def test_analytic_terms_equal_jax():
    for name in list_configs():
        cfg, jcfg = get_config(name), jbase.get_config(name)
        for kind, B, T in (("train", 256, 4096), ("prefill", 32, 32768),
                           ("decode", 128, 32768)):
            assert troof.attention_score_hbm_bytes(cfg, kind, B, T) == \
                jroof.attention_score_hbm_bytes(jcfg, kind, B, T)
            assert model_flops_for(cfg, kind, B * T, T) == \
                jroof.model_flops_for(jcfg, kind, B * T, T)
    assert pick_microbatches(256, 1) == 16


def test_every_full_size_cell_builds_on_fake_tensors():
    """Every (arch x shape) cell ``shape_applicable`` admits, at full
    size, with every argument and output a fake tensor."""
    built = 0
    for name in list_configs():
        cfg = get_config(name)
        for shape in tbase.SHAPES:
            if not tbase.shape_applicable(cfg, shape)[0]:
                continue
            cell = build_cell(cfg, shape, device="cpu")
            leaves = tree_leaves((cell.arg_specs, cell.out_specs))
            assert leaves and all(is_fake(x) for x in leaves), (name, shape)
            assert cell.kind == tbase.SHAPES[shape]["kind"]
            built += 1
    assert built == sum(
        tbase.shape_applicable(get_config(n), s)[0]
        for n in list_configs() for s in tbase.SHAPES)


# ---------------------------------------------------------------------------
# reduced cells: the extended count, JAX's FLOPs
# ---------------------------------------------------------------------------

SHAPE = {"decode": dict(kind="decode", seq_len=64, global_batch=2),
         "prefill": dict(kind="prefill", seq_len=32, global_batch=2),
         "train": dict(kind="train", seq_len=32, global_batch=4)}


def _reduced(name, layers=None):
    cfg = get_config(name).reduced()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def _skipped_block_flops(cfg, kind, B, T):
    """The dot FLOPs of the causally skipped KV blocks that JAX's cost
    model counts (two dots a pair; a train step runs each four times)."""
    qb, kb = min(cfg.attn_q_block, T), min(cfg.attn_kv_block, T)
    nq, nk = -(-T // qb), -(-T // kb)
    skipped = sum(1 for qi in range(nq) for ki in range(nk)
                  if cfg.causal and ki * kb > qi * qb + qb - 1)
    per_pair = 2 * (2 * B * cfg.num_heads * qb * kb * cfg.resolved_head_dim)
    layers = sum(r * len(p) for p, r in cfg.stages())
    passes = {"decode": 0, "prefill": 1, "train": 4}[kind]
    return skipped * per_pair * layers * passes


@pytest.mark.parametrize("name,kind", [
    ("stablelm-12b", "decode"), ("stablelm-12b", "prefill"),
    ("stablelm-12b", "train"), ("granite-moe-1b-a400m", "decode"),
    ("granite-moe-1b-a400m", "prefill")])
def test_flops_match_jax_cost_model(name, kind, monkeypatch):
    cfg = _reduced(name)
    shape = SHAPE[kind]
    monkeypatch.setitem(jbase.SHAPES, f"t_{kind}", shape)
    # JAX's build_cell sets the module-level batch axes its models'
    # sharding constraints read: restore them for the tests after.
    monkeypatch.setattr(jsharding, "_BATCH_AXES", jsharding._BATCH_AXES)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jcell = jbuild_cell(jbase.get_config(name).reduced(), f"t_{kind}", mesh)
    with mesh:
        compiled = jax.jit(
            jcell.fn, in_shardings=jcell.in_shardings,
            out_shardings=jcell.out_shardings,
            donate_argnums=jcell.donate_argnums).lower(
                *jcell.arg_specs).compile(
                    {"xla_backend_optimization_level": 0})
    want = analyze_hlo(compiled.as_text()).flops
    cell = build_cell(cfg, f"t_{kind}", shape=shape, device="cpu")
    assert cell.static_info == jcell.static_info
    assert cell.donate_argnums == jcell.donate_argnums
    got = cell_cost(cell).flops
    skipped = _skipped_block_flops(cfg, kind, shape["global_batch"],
                                   shape["seq_len"])
    assert (kind == "decode") == (skipped == 0)
    assert got + skipped == want, (got, skipped, want)


def test_analyze_memory_stats_and_mfu():
    cfg = _reduced("stablelm-12b")
    cell = build_cell(cfg, "t_decode", shape=SHAPE["decode"], device="cpu")
    r = analyze(cell)
    params = sum(p.numel() * p.element_size()
                 for p in cell.arg_specs[0].values())
    cache = sum(x.numel() * x.element_size()
                for x in tree_leaves(cell.arg_specs[1]))
    assert r.memory_stats["argument_bytes"] == params + cache + 2 * 4
    assert r.memory_stats["alias_bytes"] == cache
    assert r.memory_stats["output_bytes"] == cache + 2 * cfg.padded_vocab * 4
    assert r.bytes_per_device >= params          # every weight is read
    assert r.model_flops == 2 * cfg.active_param_count() * 2
    assert r.mfu == pytest.approx(r.model_flops / (r.bound_seconds * 989e12))
    assert r.to_dict()["mfu_at_bound"] == r.mfu
