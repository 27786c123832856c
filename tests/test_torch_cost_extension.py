"""``repro_torch.launch.graph_cost.cell_cost`` against one trace of the
whole cell.

The port's layer and microbatch loops unroll, so ``cell_cost`` traces a
cell cut to one and two units of its repeated layer pattern (two and
three microbatches for a train step) and extends the count linearly to
the cell.  Each case here builds a reduced cell at 3 pattern units and
holds the extended count equal to the full trace's: FLOPs, bytes and
FLOPs by dtype, exactly.  The architectures cover what could break
linearity in depth: GQA and MLA attention, dense and MoE feed-forwards,
deepseek's dense first layer outside the pattern, jamba's 8-layer
attention/mamba/MoE pattern, and the mamba and RWKV scans with their
carried state and caches.  stablelm's train cell runs 3 microbatches, so
the microbatch axis extends too; the other train cells run 2 (jamba's
1, to keep the file's time), which holds depth under gradient
accumulation.
"""

import dataclasses

import pytest

from repro_torch.configs import get_config
from repro_torch.launch.graph_cost import cell_cost, trace_cost
from repro_torch.launch.specs import build_cell

UNITS = 3

# (arch, kind, seq_len, global_batch, microbatches)
CASES = [
    ("stablelm-12b", "decode", 64, 6, None),
    ("stablelm-12b", "prefill", 32, 6, None),
    ("stablelm-12b", "train", 8, 6, 3),
    *[case
      for name, m in (("deepseek-v2-lite-16b", 2),
                      ("jamba-1.5-large-398b", 1),
                      ("rwkv6-1.6b", 2),
                      ("granite-moe-1b-a400m", 2))
      for case in ((name, "decode", 16, 2, None),
                   (name, "prefill", 8, 2, None),
                   (name, "train", 8, 2 * m, m))],
]


@pytest.mark.parametrize(
    "name,kind,seq_len,batch,microbatches", CASES,
    ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_extended_count_equals_full_trace(name, kind, seq_len, batch,
                                          microbatches):
    cfg = get_config(name).reduced()
    extra = len(cfg.first_layer_pattern or ())
    cfg = dataclasses.replace(
        cfg, num_layers=extra + UNITS * len(cfg.block_pattern))
    cell = build_cell(cfg, kind, device="cpu",
                      shape=dict(kind=kind, seq_len=seq_len,
                                 global_batch=batch),
                      num_microbatches=microbatches)
    if kind == "train":
        assert cell.static_info["num_microbatches"] == microbatches
    full = trace_cost(cell.fn, *cell.arg_specs, fake_mode=cell.fake_mode)
    ext = cell_cost(cell)
    assert (ext.flops, ext.mem_bytes) == (full.flops, full.mem_bytes)
    assert ext.flops_by_dtype == full.flops_by_dtype


# (name, arch, kind, batch, microbatches): the extension in length, from
# traces at three cut lengths to a cell eight length units longer.
LENGTH_CASES = [
    ("causal-attention", "stablelm-12b", "prefill", 2, None),
    ("bidirectional-attention", "hubert-xlarge", "prefill", 2, None),
    ("mamba", "jamba-1.5-large-398b", "prefill", 2, None),
    ("rwkv", "rwkv6-1.6b", "train", 2, 2),
]


def _mamba_only(cfg):
    """jamba's reduced width with (mamba, mlp) layers alone."""
    from repro_torch.configs.base import LayerSpec

    return dataclasses.replace(cfg, block_pattern=(LayerSpec("mamba", "mlp"),),
                               first_layer_pattern=None, num_layers=2)


@pytest.mark.parametrize("name,arch,kind,batch,microbatches", LENGTH_CASES,
                         ids=[c[0] for c in LENGTH_CASES])
def test_length_extension_equals_full_trace(name, arch, kind, batch,
                                            microbatches):
    """``cell_cost(extend_t=True)`` (traces at three cut lengths, each
    term ``a + b·T + c·block_pairs(T)``) against one trace at the cell's
    length, exactly: the attention's block pairs (causal and
    bidirectional), the scans' chunks and steps."""
    from repro_torch.launch.graph_cost import block_pairs, cut_lengths

    cfg = get_config(arch).reduced()
    if name == "mamba":
        cfg = _mamba_only(cfg)
    if name == "causal-attention":     # KV blocks twice the query's, as
        cfg = dataclasses.replace(     # the configs' 512 and 1024: the
            cfg, attn_kv_block=2 * cfg.attn_q_block)   # first cut has one
    rows = batch // (microbatches or 1)
    ts = cut_lengths(cfg, rows, 10**9)
    T = ts[-1] + 8 * (ts[1] - ts[0])
    assert cut_lengths(cfg, rows, T) == ts
    if "attention" in name:       # the pairs grow faster than the length
        pairs = [block_pairs(t, cfg.attn_q_block, cfg.attn_kv_block,
                             cfg.causal) for t in ts + [T]]
        assert pairs[1] - pairs[0] != pairs[2] - pairs[1]
    cell = build_cell(cfg, kind, device="cpu",
                      shape=dict(kind=kind, seq_len=T, global_batch=batch),
                      num_microbatches=microbatches)
    full = trace_cost(cell.fn, *cell.arg_specs, fake_mode=cell.fake_mode)
    ext = cell_cost(cell, extend_t=True)
    assert (ext.flops, ext.mem_bytes) == (full.flops, full.mem_bytes)
    assert ext.flops_by_dtype == full.flops_by_dtype
