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
