"""The launch plan and the weight packing of the eval attention kernels,
held on the CPU.

``ops/kernels/axial_attention.py::attention_plan`` is a pure function of
the shapes, the dtype and the SM count; the kernels (``csrc/
axial_attention.cu``, ``csrc/axial_attention_dual.cu``) run on the card
only, so what can be held here is that every plan is one the kernels
accept: within the card's shared memory, the blocks an SM it states,
every sequence in one tile, 16-byte aligned rows where ldmatrix and
cp.async read, the shared memory laid out as the C side lays it out.  And
that ``AxisWeights.wpack`` (``axis_weights``: tensor-core fragment order
in bf16) reads back to the plain ``[C, 3C]``, and that an axis without
its packing still serves on the CPU.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import (
    MMFiModelConfig, WiFlowMMFiModel,
)
from wiflow_tpu_torch.ops.kernels import axial_attention as ak
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
BATCHES = (1, 7, 4096)
SMS = (132, 114)
# (H, W) of the attention: the flagship's 15 keypoints x 20 steps, MM-Fi's
# 17 x 10; both C = 64 in 8 groups
SHAPES = {"flagship": (15, 20), "mmfi": (17, 10)}
C, G = 64, 8
SM_SMEM, RESERVED = 233472, 1024


def al16(n):
    return -(-n // 16) * 16


def check_axis_plan(ap, batch, length, other, dtype, sms):
    """One v2 launch along an axis of ``length`` (``other`` the other)."""
    esize = 2 if dtype == torch.bfloat16 else 4
    nseq = batch * other
    npos = ap.seqs * length
    assert ap.length == length and 1 <= ap.seqs and npos <= 80
    # staged rows: whole 16-byte words, an odd number of them
    assert ap.ldx >= C and ap.ldx * esize % 16 == 0
    assert ap.ldx * esize // 16 % 2 == 1
    # as csrc/axial_attention.cu::layout lays it out
    assert ap.layout == ((3 * C * C * 2 if esize == 2 else 0),
                         al16(ap.ldx * esize), al16(npos * ap.ldx * esize),
                         npos * (3 * C + 24) * 4)
    assert ap.smem == sum(ap.layout) <= SMEM_LIMIT
    # blocks an SM: shared memory and registers of two blocks' bounds
    most = 320
    assert 1 <= ap.blocks_per_sm
    assert ap.blocks_per_sm * (ap.smem + RESERVED) <= SM_SMEM
    assert ap.blocks_per_sm * ap.threads * (65536 // (2 * most)) <= 65536
    assert ap.threads % 32 == 0 and 128 <= ap.threads <= most
    # every sequence in one tile, the grid persistent over the tiles
    assert ap.tiles == -(-nseq // ap.seqs)
    assert ap.grid == min(ap.tiles, ap.blocks_per_sm * sms)


def check_dual_plan(dp, batch, h, w, dtype, sms):
    esize = 2 if dtype == torch.bfloat16 else 4
    assert 1 <= dp.rows <= h and 1 <= dp.cols <= w
    npos = max(dp.rows * w, dp.cols * h)
    assert npos <= 64
    if esize == 2:   # unpadded, 16-byte chunks swizzled for ldmatrix
        assert (dp.lda, dp.rstride) == (C, w * C)
    else:            # padded to an odd number of 16-byte words
        assert dp.lda * 4 % 16 == 0 and dp.lda * 4 // 16 % 2 == 1
        assert dp.rstride >= w * dp.lda and dp.rstride * 4 // 16 % 2 == 1
    # as csrc/axial_attention_dual.cu::layout lays it out
    assert dp.layout == ((3 * C * C * 2 if esize == 2 else 0),
                         al16(C * esize), al16(h * dp.rstride * esize),
                         npos * (3 * C + 24) * 4)
    assert dp.smem == sum(dp.layout)
    if dp.smem > SMEM_LIMIT:   # the launcher refuses: no block holds it
        assert dp.blocks_per_sm == 0 and dp.grid == 0
        return
    assert dp.threads % 32 == 0 and 128 <= dp.threads <= 256
    assert 1 <= dp.blocks_per_sm
    assert dp.blocks_per_sm * (dp.smem + RESERVED) <= SM_SMEM
    assert dp.blocks_per_sm * dp.threads * 128 <= 65536
    assert dp.grid == min(batch, dp.blocks_per_sm * sms)


def items(seqs, length):
    """The core's items of a tile: 2 queries of one group each."""
    return seqs * -(-length // 2) * G


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", SHAPES)
def test_attention_plan_at_model_shapes(name, batch, dtype, sms):
    h, w = SHAPES[name]
    plan = ak.attention_plan(batch, h, w, C, G, dtype, sms)
    check_axis_plan(plan.width, batch, w, h, dtype, sms)
    check_axis_plan(plan.height, batch, h, w, dtype, sms)
    check_dual_plan(plan.dual, batch, h, w, dtype, sms)
    # at both models' shapes: a thread for each item of a tile, two blocks
    # an SM
    for ap in (plan.width, plan.height):
        assert ap.blocks_per_sm == 2
        assert items(ap.seqs, ap.length) <= ap.threads
    dp = plan.dual
    assert max(items(dp.rows, w), items(dp.cols, h)) <= dp.threads
    if dtype == torch.bfloat16:
        assert dp.blocks_per_sm == 2


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@settings(max_examples=40, deadline=None)
@given(batch=st.integers(1, 5000), h=st.integers(1, 32),
       w=st.integers(1, 32), sms=st.integers(1, 132))
def test_attention_plan_any_shape(dtype, batch, h, w, sms):
    plan = ak.attention_plan(batch, h, w, C, G, dtype, sms)
    check_axis_plan(plan.width, batch, w, h, dtype, sms)
    check_axis_plan(plan.height, batch, h, w, dtype, sms)
    check_dual_plan(plan.dual, batch, h, w, dtype, sms)


@pytest.mark.parametrize("bad", [
    dict(c=64, groups=4),          # C is not 8 x G
    dict(c=24, groups=3),          # C is not a multiple of 16
    dict(h=33),                    # L > 32 along H
    dict(w=33),                    # L > 32 along W
    dict(dtype=torch.float16),
])
def test_attention_plan_refuses_what_the_kernels_cannot_take(bad):
    args = dict(batch=4, h=15, w=20, c=64, groups=8, dtype=torch.bfloat16)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        ak.attention_plan(*args.values())


def test_a_sample_too_large_for_one_block_leaves_the_dual_kernel_out():
    dp = ak.attention_plan(2, 32, 32, 128, 16, torch.float32).dual
    assert dp.smem > SMEM_LIMIT and dp.blocks_per_sm == 0 and dp.grid == 0


# -- the packing -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def state_dict(name):
    gen = torch.Generator().manual_seed(5)
    if name == "flagship":
        m = WiFlowPoseModel(ModelConfig(compute_dtype="float32"),
                            device="cpu", generator=gen)
        return m.state_dict(), "attention"
    m = WiFlowMMFiModel(MMFiModelConfig(compute_dtype="float32"),
                        device="cpu", generator=gen)
    return m.state_dict(), "att"


def from_fragments(f, kp, n):
    """The inverse of ``fragments.to_fragments``: ``[K, N]``."""
    return f.reshape(kp // 16, n // 8, 8, 4, 2, 2).permute(
        0, 4, 3, 5, 1, 2).reshape(kp, n)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", SHAPES)
def test_packed_wq_reads_back_to_the_plain_matrix(name, dtype):
    sd, prefix = state_dict(name)
    for aw in ak.pack_axial_attention(sd, prefix, dtype=dtype,
                                      device=torch.device("cpu")):
        assert aw.wpack.dtype == dtype and aw.wpack.is_contiguous()
        assert aw.wpack.shape == (3 * C * C,)
        back = aw.wpack if dtype == torch.float32 else from_fragments(
            aw.wpack, C, 3 * C)
        assert torch.equal(back.reshape(C, 3 * C), aw.wq)


def test_fragment_order_is_the_mma_b_layout():
    """Lane ``4 gid + tig`` of k-step ks, n-tile nt holds rows 2 tig, 2 tig
    + 1, 2 tig + 8, 2 tig + 9 of its 16-deep step at column gid."""
    m = torch.arange(C * 3 * C, dtype=torch.float32).reshape(C, 3 * C)
    aw = ak.axis_weights(ak.AxisWeights(m.to(torch.bfloat16), None, None,
                                        None))
    f = aw.wpack.float().reshape(C // 16, 3 * C // 8, 32, 4)
    ks, nt, gid, tig = 3, 17, 5, 2
    rows = [16 * ks + 2 * tig + d for d in (0, 1, 8, 9)]
    col = 8 * nt + gid
    want = m.to(torch.bfloat16).float()[rows, col]
    assert torch.equal(f[ks, nt, 4 * gid + tig], want)


def axes_for(c, groups, seed, pack):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        t = lambda *s: torch.from_numpy(  # noqa: E731
            rng.standard_normal(s).astype(np.float32))
        aw = ak.AxisWeights(t(c, 3 * c) / c ** 0.5, 0.5 * t(3 * c),
                            torch.stack([0.3 + 0.1 * t(groups).abs(),
                                         t(groups)]),
                            torch.stack([1 + 0.1 * t(c), 0.1 * t(c)]))
        out.append(ak.axis_weights(aw) if pack else aw)
    return tuple(out)


@pytest.mark.parametrize("c,groups", [(64, 8), (24, 3)])
def test_an_axis_without_its_packing_serves_on_the_cpu(c, groups):
    """The plain versions read only ``wq``: an axis with no ``wpack`` (hand
    made, or of a width the kernels do not take, which ``axis_weights``
    leaves unpacked) serves every lowering on the CPU."""
    bare = axes_for(c, groups, 0, pack=False)
    packed = axes_for(c, groups, 0, pack=True)
    assert all(aw.wpack is None for aw in bare)
    assert all((aw.wpack is None) == (c % 16 != 0) for aw in packed)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 5, 6, c)).astype(np.float32))
    ref = ak.dual_axial_attention_fused_plain(x, packed)
    for fn in (ak.dual_axial_attention_eval,
               ak.dual_axial_attention_eval_fused):
        got = fn(x, bare)
        assert got.shape == x.shape and torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
