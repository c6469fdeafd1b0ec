"""The launch plans of the ``stage`` kernels, held on the CPU.

``ops/kernels/stage_fused.py::stage_plan`` is a pure function of the
geometry and the dtype: it picks the path (tensor-core GEMM, direct,
fp32 FMA), the tiles, the padding, the grid and the shared memory of the
three kernels of a stage.  The kernels run on the card only, so what can
be held here is that every plan is one the kernels accept: within the
card's shared memory, padded as the tensor cores need, covering every
position and channel exactly once, and aligned as the vector loads
assume.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.ops.kernels import stage_fused as sk
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
STEP = sk.step_launches(ModelConfig(), 256)[0]
SMALL = sk.step_launches(ModelConfig(), 7)[0]
MMFI = sk.mmfi_stage_cases(33)


def geometry(case):
    return sk.stage_geometry(case["kind"], case["lead"], case["ci"],
                             case["co"], case["groups"], case["dil"])


def label(case):
    return (f"{case['kind']}-{'x'.join(map(str, case['lead']))}-"
            f"{case['ci']}to{case['co']}-g{case['groups']}-d{case['dil']}")


def tap_source(g, dgrad, w, j):
    """The A-side position that tap ``j`` of output position ``w`` reads,
    or None outside the row."""
    wa = g.wout if dgrad else g.win
    if dgrad:
        t = w - (j - g.pad) * g.dil
        ok = t >= 0 and t % g.stride == 0 and t // g.stride < wa
        return t // g.stride if ok else None
    ai = w * g.stride + (j - g.pad) * g.dil
    return ai if 0 <= ai < wa else None


def check_conv(g, plan, esize, dgrad):
    cig, cog = g.ci // g.groups, g.co // g.groups
    ca, cn = (cog, cig) if dgrad else (cig, cog)
    wo = g.win if dgrad else g.wout
    assert plan.smem <= SMEM_LIMIT
    if plan.path == "mma_stream":
        # dense pointwise bf16: weight tiles of 64 x 64 fp32 copied 16
        # bytes at a time, so every weight row starts on 16 bytes; at most
        # 5 row tiles of positions beside the ring
        assert esize == 2 and g.groups == 1 and g.ktaps == 1
        assert g.ci % 4 == 0 and g.co % 4 == 0 and plan.vec == 4
        assert plan.tnc == 64 and plan.mtiles <= 5 and plan.gpb == 1
        assert 1 <= plan.nt <= plan.nchunks and plan.grid_y == plan.nt
        return check_tiles(g, plan, dgrad, cn, 1)
    else:
        assert plan.path == ("mma" if esize == 2 else "fma")
    # padding: the reduction in 16s (one mma.sync k-step), columns in 8s
    assert plan.kpad % 16 == 0 and plan.kpad >= ca
    assert plan.npad % 8 == 0 and plan.npad >= cn
    assert plan.tnc % 8 == 0 and 1 <= plan.nt <= 4
    assert g.groups % plan.gpb == 0 and plan.grid_y == g.groups // plan.gpb
    check_tiles(g, plan, dgrad, cn, plan.grid_y)


def check_tiles(g, plan, dgrad, cn, blocks_y):
    esize = 4 if plan.path == "fma" else 2
    wo = g.win if dgrad else g.wout
    ca = (g.co if dgrad else g.ci) // g.groups
    if plan.gpb > 1:
        assert plan.nchunks == 1 and plan.tnc == plan.gpb * plan.npad
    # shared-memory rows: 16-byte aligned, and an odd number of 16-byte
    # words long, so that 8 rows of an ldmatrix fall in 8 different banks
    pad = 16 // esize
    lds = [plan.gpb * plan.kpad + pad]
    if plan.path != "mma_stream":
        lds.append(g.ktaps * plan.kpad + pad)
    for ld in lds:
        assert ld * esize % 16 == 0 and ld * esize // 16 % 2 == 1
    # the vector loads: 4 channels at a time only where every row of a
    # group starts on a multiple of 4 channels
    assert plan.vec in (1, 4)
    if plan.vec == 4:
        assert ca % 4 == 0 and (g.groups * ca) % 4 == 0
    # every output position belongs to exactly one tile, and every tap
    # reads inside what the tile stages
    seen = np.zeros((g.rows, wo), np.int32)
    tiles = list(sk.plan_tiles(g, plan, dgrad))
    assert 1 <= plan.grid_x <= len(tiles)
    assert plan.mtiles * 16 >= plan.rows * plan.strip
    for t in tiles:
        seen[t.row0:t.row0 + t.rows, t.w0:t.w0 + t.width] += 1
        assert t.rows * t.a_count <= plan.arows
        if plan.strips > 1:
            assert t.rows == 1
            for w in (t.w0, t.w0 + t.width - 1):
                for j in range(g.ktaps):
                    src = tap_source(g, dgrad, w, j)
                    assert src is None or t.a_lo <= src < t.a_lo + t.a_count
    assert (seen == 1).all()
    # every output channel belongs to exactly one (block, chunk, column)
    chan = np.zeros(g.groups * cn, np.int32)
    for by in range(blocks_y):
        for bc in range(plan.nchunks * plan.tnc):
            gl, n = (bc // plan.npad, bc % plan.npad) if plan.gpb > 1 else (
                0, bc)
            if n < cn and gl < plan.gpb:
                chan[(by * plan.gpb + gl) * cn + n] += 1
    assert (chan == 1).all()


def check_wgrad(g, plan, esize):
    cig, cog = g.ci // g.groups, g.co // g.groups
    assert plan.path == ("mma" if esize == 2 else "fma")
    assert plan.smem <= SMEM_LIMIT
    assert plan.ntm * plan.tmw >= cog and (plan.ntm - 1) * plan.tmw < cog
    assert plan.ntn * plan.tnw >= cig and (plan.ntn - 1) * plan.tnw < cig
    assert plan.kp % 16 == 0 and plan.kp >= plan.rows * plan.strip
    if esize == 2:
        # positions are K: 16 a step; a warp keeps one 16-row tile of M
        # and at most 12 (8-column tile, tap) pairs
        assert plan.tmw in (16, 32, 64, 128) and plan.tnw % 8 == 0
        per_warp = 8 // (plan.tmw // 16)
        assert -(-plan.tnw // 8 * g.ktaps // per_warp) <= 12
    else:
        assert plan.tmw % 4 == 0 and plan.tnw % 4 == 0
        assert (plan.tmw // 4) * (plan.tnw // 4) <= 256
    for vec, c in ((plan.vec_g, cog), (plan.vec_a, cig)):
        assert vec in (1, 4) and (vec == 1 or c % 4 == 0)
    steps = list(sk.plan_tiles(g, plan))
    assert (plan.splits - 1) * plan.steps_per_split < len(steps)
    assert plan.splits * plan.steps_per_split >= len(steps)
    seen = np.zeros((g.rows, g.wout), np.int32)
    for t in steps:
        seen[t.row0:t.row0 + t.rows, t.w0:t.w0 + t.width] += 1
        assert t.rows * t.a_count <= plan.arows
    assert (seen == 1).all()


def check_plan(g, dtype):
    esize = 2 if dtype == torch.bfloat16 else 4
    plan = sk.stage_plan(g, dtype)
    if g.ci == 1 and g.co <= 8:
        assert plan.fwd.path == "direct"
        assert plan.fwd.rows * plan.fwd.grid_x >= g.rows * g.wout
        assert plan.fwd.rows * (plan.fwd.grid_x - 1) < g.rows * g.wout
    else:
        check_conv(g, plan.fwd, esize, False)
    check_conv(g, plan.dgrad, esize, True)
    check_wgrad(g, plan.wgrad, esize)
    return plan


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("index", range(len(STEP)),
                         ids=[f"{i}-{label(c)}" for i, c in enumerate(STEP)])
def test_plan_of_each_step_launch(index, dtype):
    """The 39 ``stage`` launches of one fused train step at batch 256."""
    check_plan(geometry(STEP[index]), dtype)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("index", range(len(SMALL)),
                         ids=[f"{i}-{label(c)}" for i, c in enumerate(SMALL)])
def test_plan_at_seven_samples(index, dtype):
    check_plan(geometry(SMALL[index]), dtype)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("index", range(len(MMFI)),
                         ids=[f"{i}-{label(c)}" for i, c in enumerate(MMFI)])
def test_plan_at_mmfi_geometries(index, dtype):
    check_plan(geometry(MMFI[index]), dtype)


def test_step_has_39_stage_launches():
    assert len(STEP) == 39 and len(SMALL) == 39


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_expected_paths(dtype):
    """One input channel goes the direct way, the dense 540-wide stage to
    the tensor cores in bf16, and fp32 never does."""
    bf16 = dtype == torch.bfloat16
    want = "mma" if bf16 else "fma"
    first = sk.stage_plan(sk.stage_geometry("sym3", (256, 20, 240), 1, 8),
                          dtype)
    assert first.fwd.path == "direct"
    assert (first.dgrad.path, first.wgrad.path) == (want, want)
    dense = sk.stage_plan(sk.stage_geometry("identity", (256, 20), 540, 540),
                          dtype)
    stream = "mma_stream" if bf16 else "fma"
    assert (dense.fwd.path, dense.dgrad.path, dense.wgrad.path) == (
        stream, stream, want)
    assert dense.fwd.nchunks > 1 and dense.fwd.vec == 4
    # 542 channels: a weight row is no multiple of 16 bytes, no streaming
    odd = sk.stage_plan(sk.stage_geometry("identity", (256, 20), 542, 542),
                        dtype)
    assert odd.fwd.path == want and odd.fwd.nchunks > 1
    # the narrow and the grouped stages keep all their weights in shared
    # memory, the grouped ones several groups a block
    narrow = sk.stage_plan(sk.stage_geometry("sym3", (256, 20, 30), 64, 64),
                           dtype)
    assert narrow.fwd.nchunks == 1 and narrow.dgrad.nchunks == 1
    grouped = sk.stage_plan(sk.stage_geometry("causal3", (256, 20), 540, 540,
                                              20, 4), dtype)
    assert grouped.fwd.nchunks == 1 and grouped.fwd.gpb > 1
    # 17 input channels with one wide output: no direct path
    wide = sk.stage_plan(sk.stage_geometry("identity", (4, 9), 1, 17), dtype)
    assert wide.fwd.path == want


def test_a_tile_that_cannot_fit_raises_with_the_sizes():
    g = sk.stage_geometry("sym3", (2, 2, 300), 8192, 8)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sk.stage_plan(g, torch.float32)


def test_plan_rejects_other_dtypes():
    g = sk.stage_geometry("identity", (2, 4), 8, 8)
    with pytest.raises(TypeError):
        sk.stage_plan(g, torch.float16)


@st.composite
def odd_geometries(draw):
    kind = draw(st.sampled_from(sorted(sk._KINDS)))
    groups = draw(st.sampled_from((1, 1, 2, 3, 5, 18)))
    cig = draw(st.integers(1, 70 if groups == 1 else 29))
    cog = draw(st.integers(1, 70 if groups == 1 else 29))
    lead = (draw(st.integers(1, 9)), draw(st.integers(1, 3)),
            draw(st.sampled_from((1, 2, 3, 17, 20, 31, 255, 257, 600, 1024, 1025,
                                  2500))))
    dil = draw(st.sampled_from((1, 2, 8, 11)))
    return sk.stage_geometry(kind, lead, groups * cig, groups * cog, groups,
                             dil)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@settings(max_examples=60, deadline=None)
@given(g=odd_geometries())
def test_plan_of_odd_geometries(dtype, g):
    check_plan(g, dtype)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_plan_of_wide_dense_stages(dtype):
    """Widths past one weight chunk, odd and not a multiple of 4."""
    for ci, co in ((767, 77), (77, 767), (600, 600)):
        for kind in ("identity", "sym3", "chunk3"):
            plan = check_plan(sk.stage_geometry(kind, (3, 2, 40), ci, co),
                              dtype)
            assert plan.fwd.vec == (4 if ci % 4 == 0 else 1)
