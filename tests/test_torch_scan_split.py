"""The scan kernels' decompositions, in plain torch, against the JAX
package, and their launch plans.

``rwkv6_scan_split_plain`` (column groups of 16, K rows split over 8 row
lanes, the partials summed once a 16-token tile, the bonus once a token)
and ``mamba_scan_split_plain`` (N split over 4 lane groups, decays as
``exp2`` of ``dt`` times A scaled by log2(e), the lanes' partials summed
pairwise)
take numpy-seeded inputs beside JAX's ``rwkv6_scan_pallas`` and
``mamba_scan_pallas`` in interpret mode and the port's plain versions.
Tolerance: f32, 1e-5 of the reference's largest magnitude (at least 1),
as ``chip_smoke.py`` states its gates: the forms sum the same f32
products in another order.  The shapes sit at the designs' edges: every
K (16, 32, 64: one, two and four column groups) and N (4, 8, 16: one,
two and four states a lane), T 1 and a tile +- 1, I off the block's 32
channels, B 3, and strong decay (log w = -54.6, the model's clamp; dt
near 15).  The plans are checked from shapes alone to cover every (b, h,
v) column and every state exactly once, and the copy widths to follow
the strides.  The CUDA kernels are held to the plain versions on the
card by ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.kernels.rwkv6_scan import rwkv6_scan_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import rwkv6_scan as trwkv

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.numpy() - want).max())
    assert np.isfinite(got.numpy()).all()
    assert err <= TOL * scale, f"error {err} above {TOL} * {scale}"


# ---------------------------------------------------------------------------
# rwkv6_scan: column groups x row lanes, the tile-deferred sum
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rwkv_case(B, H, T, K, decay, chunk=16):
    """numpy inputs, JAX's Pallas y (interpret mode)."""
    rng = np.random.default_rng([B, H, T, K, decay == "strong"])
    shape = (B, H, T, K)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    if decay == "strong":     # the clamp's floor: -exp(4) every token
        logw = np.full(shape, -np.exp(4.0), np.float32)
    else:
        logw = -np.exp(rng.standard_normal(shape) * 0.5 - 1.0)
    logw = logw.astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    xs = (r, k, v, logw, u)
    want = np.asarray(rwkv6_scan_pallas(*map(jnp.asarray, xs),
                                         chunk=chunk))
    return xs, want


@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("T", [1, 15, 16, 17])
def test_rwkv_split_matches_pallas_and_plain(K, T):
    xs, want = _rwkv_case(2, 2, T, K, "model")
    ts = [torch.from_numpy(x) for x in xs]
    y, S = trwkv.rwkv6_scan_split_plain(*ts)
    y_plain, S_plain = trwkv.rwkv6_scan_plain(*ts)
    _close(y, want)
    _close(y, y_plain)
    _close(S, S_plain)


@pytest.mark.parametrize("K", [16, 64])
def test_rwkv_split_strong_decay_b3(K):
    """log w = -54.6 every token.  The Pallas call runs at chunk 1 here:
    at chunk 16 its cumulative sums of log w reach -873, and rounding
    them costs the adjacent pair decay (exactly 1) about 6e-5, which puts
    the Pallas kernel itself about 1.2e-5 of the largest |y| off JAX's
    sequential oracle; at chunk 1 every exponent is exact and the state
    is carried from chunk to chunk."""
    xs, want = _rwkv_case(3, 1, 33, K, "strong", chunk=1)
    ts = [torch.from_numpy(x) for x in xs]
    y, S = trwkv.rwkv6_scan_split_plain(*ts)
    y_plain, S_plain = trwkv.rwkv6_scan_plain(*ts)
    _close(y, want)
    _close(y, y_plain)
    _close(S, S_plain)


@pytest.mark.parametrize("B,H,K", [(1, 32, 64), (3, 5, 64), (2, 3, 32),
                                   (3, 2, 16), (1, 1, 16)])
def test_rwkv_plan_covers_every_state_once(B, H, K):
    plan = trwkv.rwkv6_scan_plan(B, H, K)
    assert plan.grid == B * H * (K // 16) and plan.threads == 256
    assert plan.col_groups * trwkv.BLOCK_COLS == K
    hits = np.zeros((B, H, K, K), np.int64)
    cols = np.zeros((B, H, K), np.int64)
    for block in range(plan.grid):
        for thread in range(plan.threads):
            b, h, col, rows = trwkv.rwkv6_thread_cells(plan, H, K, block,
                                                       thread)
            if thread >= trwkv.WALKERS:     # the helpers hold no state
                assert col is None and rows == []
                continue
            assert len(rows) == plan.rows_per_lane
            hits[b, h, rows, col] += 1
            cols[b, h, col] += 1
    assert (hits == 1).all()
    assert (cols == trwkv.ROW_LANES).all()   # each column: 8 row lanes


@pytest.mark.parametrize("K", [16, 32, 64])
def test_rwkv_lane_rows_are_vector_runs(K):
    """A lane's rows come in aligned runs of Q = min(K/8, 4), one shared
    load each, and the 8 lanes of a load read one contiguous span."""
    q = min(K // 8, 4)
    for g in range(trwkv.ROW_LANES):
        rows = trwkv.rwkv6_lane_rows(K, g)
        for e in range(0, len(rows), q):
            run = rows[e:e + q]
            assert run[0] % q == 0 and run == list(range(run[0],
                                                         run[0] + q))
    first = sorted(trwkv.rwkv6_lane_rows(K, g)[0] for g in range(8))
    assert first == list(range(0, 8 * q, q))


def _rwkv_tensors(B, H, T, K, dtype, layout):
    """Zero operands in the model's view layout, contiguous, or as
    slices at element 1 of a wider last dim (odd strides)."""
    if layout == "view":
        base = torch.zeros((B, T, H, K), dtype=dtype)
        xs = [base.clone().transpose(1, 2) for _ in range(4)]
    elif layout == "contiguous":
        xs = [torch.zeros((B, H, T, K), dtype=dtype) for _ in range(4)]
    else:
        xs = [torch.zeros((B, H, T, K + 1), dtype=dtype)[..., 1:]
              for _ in range(4)]
    return xs + [torch.zeros((H, K), dtype=dtype)]


@pytest.mark.parametrize("dtype,layout,K,want", [
    (torch.float32, "view", 64, 16), (torch.bfloat16, "view", 64, 16),
    (torch.bfloat16, "view", 16, 16), (torch.float32, "odd", 64, 4),
    (torch.bfloat16, "odd", 32, 2), (torch.float32, "contiguous", 16, 16)])
def test_rwkv_copy_width_follows_strides(dtype, layout, K, want):
    xs = _rwkv_tensors(2, 3, 17, K, dtype, layout)
    code, dims, strides, width = trwkv.rwkv6_scan_launch_args(*xs)
    assert width == want
    assert dims == (2, 3, 17, K, K // 16) and code == trwkv.DTYPES[dtype]
    size = xs[0].element_size()
    assert all(s * size % width == 0 for s in list(strides)[:12])
    ptrs = [x.data_ptr() for x in xs[:4]]
    assert _build.pointer_width(width, *ptrs) <= width
    if layout == "odd":      # the slice starts one element in
        assert _build.pointer_width(16, ptrs[0]) == size


# ---------------------------------------------------------------------------
# mamba_scan: N over lane groups
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mamba_case(B, T, I, N, decay):
    """numpy inputs, JAX's Pallas y (interpret mode, chunk 4, one
    channel block: I need not be a multiple of anything there)."""
    rng = np.random.default_rng([B, T, I, N, decay == "strong"])
    xdt = rng.standard_normal((B, T, I))
    if decay == "strong":
        dt = 15.0 + rng.uniform(-5.0, 5.0, (B, T, I))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, T, I))))   # softplus
    bc = rng.standard_normal((B, T, N))
    cc = rng.standard_normal((B, T, N))
    a = -np.exp(rng.standard_normal((I, N)) * 0.3) * np.arange(1, N + 1)
    xs = tuple(x.astype(np.float32) for x in (dt * xdt, dt, bc, cc, a))
    want = np.asarray(mamba_scan_pallas(*map(jnp.asarray, xs), chunk=4,
                                        block_i=I))
    return xs, want


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("T", [1, 31, 32, 33])
def test_mamba_split_matches_pallas_and_plain(N, T):
    xs, want = _mamba_case(3, T, 40, N, "model")
    ts = [torch.from_numpy(x) for x in xs]
    y, h = tmamba.mamba_scan_split_plain(*ts)
    y_plain, h_plain = tmamba.mamba_scan_plain(*ts)
    _close(y, want)
    _close(y, y_plain)
    _close(h, h_plain)


@pytest.mark.parametrize("N", [4, 16])
def test_mamba_split_strong_decay(N):
    xs, want = _mamba_case(1, 20, 33, N, "strong")
    assert float(xs[1].min()) >= 10.0      # every decay below e^-7
    ts = [torch.from_numpy(x) for x in xs]
    y, h = tmamba.mamba_scan_split_plain(*ts)
    y_plain, h_plain = tmamba.mamba_scan_plain(*ts)
    _close(y, want)
    _close(y, y_plain)
    _close(h, h_plain)


@pytest.mark.parametrize("B,I,N", [(1, 16384, 16), (3, 100, 4), (2, 40, 8),
                                   (3, 31, 16), (1, 32, 4), (2, 65, 8)])
def test_mamba_plan_covers_every_state_once(B, I, N):
    plan = tmamba.mamba_scan_plan(B, I, N)
    assert plan.i_blocks == -(-I // 32) and plan.grid == B * plan.i_blocks
    assert plan.states_per_lane * tmamba.LANES == N
    hits = np.zeros((B, I, N), np.int64)
    for block in range(plan.grid):
        for thread in range(plan.threads):
            b, cells = tmamba.mamba_thread_cells(plan, I, block, thread)
            assert len(cells) <= 1      # a lane holds one channel
            for i, states in cells:
                assert i < I and len(states) == plan.states_per_lane
                hits[b, i, states] += 1
    assert (hits == 1).all()


def _mamba_tensors(B, T, I, N, dtype, R):
    """Zero operands, bc and cc as column slices of one [B,T,R+2N]
    projection, as the model's x_proj output hands them over."""
    proj = torch.zeros((B, T, R + 2 * N), dtype=dtype)
    return [torch.zeros((B, T, I), dtype=dtype),
            torch.zeros((B, T, I), dtype=dtype), proj[..., R:R + N],
            proj[..., R + N:], torch.zeros((I, N), dtype=torch.float32)]


@pytest.mark.parametrize("dtype,N,R,want", [
    (torch.float32, 16, 512, (16, 16)), (torch.bfloat16, 16, 512, (16, 16)),
    (torch.float32, 16, 5, (16, 4)), (torch.bfloat16, 16, 5, (16, 2)),
    (torch.bfloat16, 4, 8, (16, 8)), (torch.float32, 8, 2, (16, 8))])
def test_mamba_copy_widths_follow_strides(dtype, N, R, want):
    xs = _mamba_tensors(2, 33, 128, N, dtype, R)
    codes, dims, widths, strides = tmamba.mamba_scan_launch_args(*xs)
    assert widths == want and dims == (2, 33, 128, N, 4)
    assert codes == (tmamba.DTYPES[dtype], 0)
    size = xs[0].element_size()
    for d, width in ((0, widths[0]), (1, widths[0]), (2, widths[1]),
                     (3, widths[1])):
        assert strides[2 * d] * size % width == 0
        assert strides[2 * d + 1] * size % width == 0
    # the slices' own pointers narrow the width per call
    got = _build.pointer_width(widths[1], xs[2].data_ptr(),
                               xs[3].data_ptr())
    assert got <= widths[1] and xs[2].data_ptr() % got == 0


def test_copy_width_and_pointer_width():
    assert _build.copy_width(4, [64, 2048], [256]) == 16
    assert _build.copy_width(4, [65], [256]) == 4
    assert _build.copy_width(2, [66], [32]) == 4
    assert _build.copy_width(2, [33], [32]) == 2
    assert _build.copy_width(2, [64], [8]) == 8
    assert _build.pointer_width(16, 0x1000, 0x1008) == 8
    assert _build.pointer_width(16, 0x1002) == 2
    assert _build.pointer_width(4, 0x1000) == 4
