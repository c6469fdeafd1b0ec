"""The launch plans and weight packings of the serving kernels, held on
the CPU.

``ops/kernels/conv_stack.py::conv_stack_plan`` and
``ops/kernels/tcn_level.py::tcn_plan`` are pure functions of the shapes and
the dtype; the kernels run on the card only, so what can be held here is
that every plan is one the kernels accept (within the card's shared
memory, the blocks an SM it states, every row computed once, 16-byte
aligned where ldmatrix and cp.async read) and that the packed weights
(``stack_weights``, ``level_weights``: tensor-core fragment order,
conv3 and the shortcut in one reduction, group padding) read back to the
plain taps.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig, WiFlowMMFiModel
from wiflow_tpu_torch.ops.kernels import conv_stack as ck
from wiflow_tpu_torch.ops.kernels import tcn_level as tk
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT
from wiflow_tpu_torch.ops.kernels.fragments import to_fragments

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
BATCHES = (1, 7, 4096)
MODELS = ("flagship", "mmfi")


@functools.lru_cache(maxsize=None)
def model(name):
    """(config, fp32 state_dict) of a seeded model."""
    gen = torch.Generator().manual_seed(3)
    if name == "flagship":
        cfg = ModelConfig(compute_dtype="float32")
        m = WiFlowPoseModel(cfg, device="cpu", generator=gen)
    else:
        cfg = MMFiModelConfig(compute_dtype="float32")
        m = WiFlowMMFiModel(cfg, device="cpu", generator=gen)
    with torch.no_grad():   # nonzero biases and shortcuts everywhere
        for k, v in m.state_dict().items():
            if k.endswith(".bias") or k.endswith("running_mean"):
                v.add_(0.1 * torch.randn(v.shape, generator=gen))
    return cfg, m.state_dict()


@functools.lru_cache(maxsize=None)
def stack(name, dtype):
    cfg, sd = model(name)
    return ck.pack_conv_stack(sd, len(cfg.conv_channels), dtype=dtype,
                              device=torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def levels(name, dtype):
    cfg, sd = model(name)
    return tk.pack_tcn_levels(sd, len(cfg.tcn_channels), cfg.tcn_groups,
                              dtype=dtype, device=torch.device("cpu"))


def conv_w0(name):
    cfg, _ = model(name)
    return getattr(cfg, "tcn_proj_channels", cfg.tcn_channels[-1])


# -- reading the packed weights back -----------------------------------------

def from_fragments(f, kp, n):
    """The inverse of ``to_fragments``: ``[K, N]``."""
    return f.reshape(kp // 16, n // 8, 8, 4, 2, 2).permute(
        0, 4, 3, 5, 1, 2).reshape(kp, n)


def conv_k_matrices(stack):
    """The packed weights read back: per block, per conv, its ``[K_pad,
    C_out]`` fp32 matrix (empty for an elementwise conv)."""
    shapes, _, _ = ck._stack_shapes(ck._chans(stack.blocks))
    out = []
    for sh in shapes:
        mats = []
        for cs in sh.convs:
            kp = cs.ksteps * 16
            f = stack.wpack[cs.woff:cs.woff + kp * sh.co].float().cpu()
            if stack.wpack.dtype == torch.bfloat16:
                f = from_fragments(f, kp, sh.co)
            mats.append(f.reshape(kp, sh.co))
        out.append(mats)
    return out


def unpack_level(lv):
    """``kw`` read back into the five matrices of ``level_matrices``."""
    cin, cout = lv.p1w.shape
    groups = lv.g1w.shape[1]
    lay = tk._weight_layout(cin, cout, groups, lv.dw is not None)
    kw = lv.kw.float().cpu()
    shapes = [(groups, 16 * lay.ks[0], tk._cgp(cin // groups)),
              (groups, 16 * lay.ks[1], tk._cgp(cout // groups))] + [
        (16 * k, 8 * lay.ntiles) for k in lay.ks[2:]]
    out = []
    for off, shape in zip(lay.offs, shapes):
        n = 1
        for d in shape:
            n *= d
        f = kw[off:off + n]
        if lv.kw.dtype == torch.bfloat16 and n:
            if len(shape) == 3:
                per = n // shape[0]
                f = torch.stack([from_fragments(f[i * per:(i + 1) * per],
                                                *shape[1:])
                                 for i in range(shape[0])])
            else:
                f = from_fragments(f, *shape)
        out.append(f.reshape(shape))
    return out


# -- the conv stack ---------------------------------------------------------

def check_conv_plan(plan, rows, w0, chans, dtype):
    """What ``csrc/conv_stack.cu::plan_ok`` and the kernel assume."""
    esize = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem <= SMEM_LIMIT
    assert plan.blocks_per_sm * plan.smem <= SMEM_LIMIT
    assert plan.wfrag == (0 if esize == 4 else plan.wfrag)
    assert plan.wfrag % 8 == 0 and plan.row_elems % 8 == 0
    assert plan.row_elems >= w0
    # the shared memory adds up as the C side lays it out
    al = lambda v: -(-v // 16) * 16   # noqa: E731
    assert plan.smem == (al(4 * plan.nvec) + al(2 * plan.wfrag) + 512
                         + 3 * plan.tile_rows * plan.row_elems * esize)
    # every row in exactly one tile, every tile in exactly one block
    ntiles = -(-rows // plan.tile_rows)
    assert 1 <= plan.grid <= ntiles and plan.tile_rows >= 1
    seen = np.zeros(rows, np.int32)
    for b in range(plan.grid):
        for t in range(b, ntiles, plan.grid):
            seen[t * plan.tile_rows:(t + 1) * plan.tile_rows] += 1
    assert (seen == 1).all()
    dims = np.array(plan.dims).reshape(len(chans), 24)
    cin, win, ld_in = 1, w0, 1
    for d, (ci, co, stride), ld, units in zip(dims, chans, plan.lds,
                                              plan.units):
        assert tuple(d[:7]) == (ci, co, stride, win, (win - 1) // stride + 1,
                                ld_in, ld)
        assert ci == cin and co % 8 == 0 and ld >= co
        # ldmatrix rows: 16 bytes each, an odd number of 16-byte words
        assert ld % 8 == 0 and (ld // 8) % 2 == 1
        assert d[4] * ld <= plan.row_elems
        chunks = (3 * ci // 8, 3 * co // 8,
                  3 * co // 8 + (ci // 8 if ci > 1 else 0))
        for j, (ks, mtu, nt, woff, boff) in enumerate(d[7:22].reshape(3, 5)):
            assert boff + co <= plan.nvec
            if j == 0 and ci == 1:
                assert ks == 0
                continue
            # a unit shape the kernel has, whole n-tile groups
            assert (mtu, nt) == units[j] and (mtu, nt) in ck.UNIT_SHAPES
            assert (co // 8) % nt == 0
            assert 2 * ks >= chunks[j] > 2 * ks - 2
            assert woff % 8 == 0        # 16-byte aligned fragments
        if ci == 1:
            assert d[22] + 3 * co <= plan.nvec and d[23] + co <= plan.nvec
        else:
            assert tuple(d[22:]) == (-1, -1)
        cin, win, ld_in = co, d[4], ld


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_plan_at_model_shapes(name, batch, dtype):
    cfg, _ = model(name)
    chans = ck._chans(stack(name, dtype))
    rows = batch * cfg.window_size
    plan = ck.conv_stack_plan(rows, conv_w0(name), chans, dtype)
    check_conv_plan(plan, rows, conv_w0(name), chans, dtype)
    assert plan.widths[-1] == (15 if name == "flagship" else 17)
    if batch == 4096:
        # the grid is one block on each of the card's 132 SMs, and bf16
        # keeps every weight in shared memory beside at least 8 rows
        assert plan.grid == 132 and plan.blocks_per_sm == 1
        if dtype == torch.bfloat16:
            assert plan.tile_rows >= 8 and plan.wfrag > 40000


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@settings(max_examples=40, deadline=None)
@given(batch=st.integers(1, 5000), name=st.sampled_from(MODELS),
       sms=st.sampled_from((1, 7, 132)))
def test_conv_stack_plan_any_batch(dtype, batch, name, sms):
    cfg, _ = model(name)
    chans = ck._chans(stack(name, dtype))
    rows = batch * cfg.window_size
    plan = ck.conv_stack_plan(rows, conv_w0(name), chans, dtype, sms)
    check_conv_plan(plan, rows, conv_w0(name), chans, dtype)
    assert plan.grid <= sms


def test_fragment_order_is_the_mma_b_layout():
    """Lane 4 gid + tig of the fragment at (k-step, n-tile) holds rows 2 tig,
    2 tig + 1, 2 tig + 8, 2 tig + 9 of the step at column gid."""
    m = torch.arange(48 * 24, dtype=torch.float32).reshape(48, 24)
    f = to_fragments(m).reshape(3, 3, 32, 4)
    for ks in range(3):
        for nt in range(3):
            for lane in range(32):
                gid, tig = divmod(lane, 4)
                rows = [ks * 16 + 2 * tig + r for r in (0, 1, 8, 9)]
                assert f[ks, nt, lane].tolist() == [
                    m[r, nt * 8 + gid].item() for r in rows]
    assert torch.equal(from_fragments(to_fragments(m), 48, 24), m)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_packing_reads_back_to_the_taps(name, dtype):
    """Each conv's [K, C_out]: taps tap-major, conv3 followed by the strided
    shortcut's rows, zero padding to 16; the vectors hold b1, b2, b3 + e
    and a 1-channel block's taps."""
    st_ = stack(name, dtype)
    assert st_.wpack.dtype == dtype and st_.vec.dtype == torch.float32
    shapes, _, _ = ck._stack_shapes(ck._chans(st_))
    for blk, mats, sh in zip(st_, conv_k_matrices(st_), shapes):
        ci, co = blk.w1.shape[1:]
        want = [blk.w1.float().reshape(3 * ci, co),
                blk.w2.float().reshape(3 * co, co),
                blk.w3.float().reshape(3 * co, co)]
        if ci > 1:
            want[2] = torch.cat([want[2], blk.wd.float()])
        for j, (got, w) in enumerate(zip(mats, want)):
            if j == 0 and ci == 1:
                assert got.numel() == 0
                continue
            assert got.shape[0] % 16 == 0 and got.shape[0] - w.shape[0] < 16
            assert torch.equal(got[:w.shape[0]], w)
            assert not got[w.shape[0]:].any()
            # row 3 co + c of conv3 is the shortcut's input channel c
            if j == 2 and ci > 1:
                assert torch.equal(got[3 * co + ci - 1], blk.wd[-1].float())
        v = st_.vec
        for j, b in enumerate((blk.b1, blk.b2, blk.b3 + blk.bd)):
            o = sh.convs[j].boff
            assert torch.equal(v[o:o + co], b)
        if ci == 1:
            assert torch.equal(v[sh.w1off:sh.w1off + 3 * co],
                               blk.w1.float().reshape(-1))
            assert torch.equal(v[sh.wdoff:sh.wdoff + co],
                               blk.wd.float().reshape(-1))


def test_conv_stack_widths_the_kernel_does_not_take():
    """4 channels pack for the plain version only; a launch plan raises."""
    cfg = ModelConfig(conv_channels=(4, 8, 16, 32), compute_dtype="float32")
    sd = WiFlowPoseModel(cfg, device="cpu").state_dict()
    s = ck.pack_conv_stack(sd, 4, dtype=torch.float32,
                           device=torch.device("cpu"))
    assert s.wpack is None and len(s) == 5
    assert ck.fused_conv_stack_eval(torch.zeros(3, 240), s).shape == (
        3, 32, 15)
    with pytest.raises(ValueError, match="multiple of 8"):
        ck.conv_stack_plan(60, 240, ck._chans(s), torch.float32)
    with pytest.raises(TypeError):
        ck.conv_stack_plan(60, 240, ck._chans(stack("flagship",
                                                     torch.float32)),
                           torch.float16)


# -- the TCN level ----------------------------------------------------------

def level_cases(name):
    cfg, _ = model(name)
    cin = getattr(cfg, "input_channels", cfg.num_subcarriers)
    out = []
    for i, cout in enumerate(cfg.tcn_channels):
        out.append((i, cin, cout))
        cin = cout
    return out


def check_tcn_plan(plan, batch, steps, cin, cout, groups, dil, has_d, dtype):
    """What ``csrc/tcn_level.cu::plan_ok`` and the kernel assume."""
    esize = 2 if dtype == torch.bfloat16 else 4
    (b, t, ci, co, g, d, samples, cgp_in, cgp_out, ldg_in, ldd_in, ldg_out,
     ldd_out, buf0, buf1, ntiles, ks_g1, ks_g2, ks_p1, ks_p2, ks_d, grid,
     smem, off_g1, off_g2, off_p1, off_p2, off_d) = plan.dims
    assert (b, t, ci, co, g, d) == (batch, steps, cin, cout, groups, dil)
    assert smem == plan.smem <= SMEM_LIMIT
    assert plan.blocks_per_sm * smem <= SMEM_LIMIT
    # whole samples a tile, padded to the tensor cores' 16-row tiles
    assert samples == plan.samples and samples * steps <= plan.rows
    assert plan.rows % 16 == 0 and plan.rows == (64 if esize == 2 else 32)
    ntm = -(-batch // samples)
    assert grid == plan.grid and 1 <= grid <= ntm
    seen = np.zeros(batch, np.int32)
    for blk in range(grid):
        for tile in range(blk, ntm, grid):
            seen[tile * samples:(tile + 1) * samples] += 1
    assert (seen == 1).all()
    # group padding: every group's channels start on 16 bytes
    for cgp, c in ((cgp_in, cin), (cgp_out, cout)):
        assert cgp % 8 == 0 and c // groups <= cgp < c // groups + 8
        assert cgp <= 32
    # rows of the layouts: 16 bytes aligned, an odd number of 16-byte
    # words, wide enough; the buffers hold every layout they take
    for ld, need in ((ldg_in, groups * cgp_in), (ldg_out, groups * cgp_out),
                     (ldd_in, -(-cin // 16) * 16),
                     (ldd_out, -(-cout // 16) * 16)):
        assert ld % 8 == 0 and (ld // 8) % 2 == 1 and need <= ld < need + 16
    assert buf0 >= max(ldg_in, ldg_out, ldd_in) and buf1 >= max(ldd_in,
                                                                ldd_out)
    # products: all of N in one pass of 16 warps, 2 x 8, <= 9 n-tiles each
    assert ntiles == -(-cout // 8) and plan.ntw * 8 >= ntiles
    assert plan.ntw <= 9
    assert (ks_p1, ks_p2, ks_d) == (-(-cin // 16), -(-cout // 16),
                                    -(-cin // 16) if has_d else 0)
    assert (ks_g1, ks_g2) == (-(-3 * cgp_in // 16), -(-3 * cgp_out // 16))
    # the weight stream: G1, G2, then P1, P2, D back to back, the ring's
    # k-steps 16-byte aligned (cp.async)
    g1 = groups * ks_g1 * 16 * cgp_in
    g2 = groups * ks_g2 * 16 * cgp_out
    step = ntiles * 8 * 16
    assert (off_g1, off_g2, off_p1) == (0, g1, g1 + g2)
    assert off_p2 == off_p1 + ks_p1 * step and off_d == off_p2 + ks_p2 * step
    assert (off_p1 * esize) % 16 == 0 and (step * esize) % 16 == 0
    ring = plan.stages * (ntiles * 256 + 16)   # slots and their mbarriers
    assert plan.stages == (4 if esize == 2 else 0)
    al = lambda v: -(-v // 16) * 16   # noqa: E731
    assert smem == al(plan.rows * buf0 * esize) + al(
        plan.rows * buf1 * esize) + 32 + al(2 * (cin + cout)) + ring


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_tcn_plan_at_model_shapes(name, batch, dtype):
    cfg, _ = model(name)
    for i, cin, cout in level_cases(name):
        plan = tk.tcn_plan(batch, cfg.window_size, cin, cout, cfg.tcn_groups,
                           2 ** i, cin != cout, dtype)
        check_tcn_plan(plan, batch, cfg.window_size, cin, cout,
                       cfg.tcn_groups, 2 ** i, cin != cout, dtype)
        if batch == 4096:
            assert plan.grid == 132
        if dtype == torch.bfloat16:
            # whole samples: 3 of 20 steps, 6 of 10, in 64 rows
            assert plan.samples == 64 // cfg.window_size


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@settings(max_examples=40, deadline=None)
@given(batch=st.integers(1, 5000), name=st.sampled_from(MODELS),
       sms=st.sampled_from((1, 7, 132)), level=st.integers(0, 3))
def test_tcn_plan_any_batch(dtype, batch, name, sms, level):
    cfg, _ = model(name)
    cases = level_cases(name)
    i, cin, cout = cases[level % len(cases)]
    plan = tk.tcn_plan(batch, cfg.window_size, cin, cout, cfg.tcn_groups,
                       2 ** i, cin != cout, dtype, sms)
    check_tcn_plan(plan, batch, cfg.window_size, cin, cout, cfg.tcn_groups,
                   2 ** i, cin != cout, dtype)
    assert plan.grid <= sms


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", MODELS)
def test_tcn_packing_reads_back_to_the_taps(name, dtype):
    """G1, G2: per group, tap j's input channel i at row j cgp + i; P1, P2,
    D: the [C_in, C_out] matrix; zero wherever padded."""
    for lv in levels(name, dtype):
        assert lv.kw is not None and lv.kw.dtype == dtype
        g1, g2, p1, p2, d = unpack_level(lv)
        for got, taps in ((g1, lv.g1w), (g2, lv.g2w)):
            _, groups, ci, co = taps.shape
            cgp = got.shape[2]
            assert got.shape[0] == groups and cgp % 8 == 0
            want = torch.zeros_like(got)
            for j in range(3):
                want[:, j * cgp:j * cgp + ci, :co] = taps[j].float()
            assert torch.equal(got, want)
        for got, w in ((p1, lv.p1w), (p2, lv.p2w), (d, lv.dw)):
            if w is None:
                assert got.numel() == 0
                continue
            k, n = w.shape
            assert got.shape[0] % 16 == 0 and got.shape[1] % 8 == 0
            assert torch.equal(got[:k, :n], w.float())
            assert not got[k:].any() and not got[:, n:].any()


def test_tcn_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="channels a group"):
        tk.tcn_plan(8, 20, 660, 660, 20, 1, False, torch.bfloat16)
    with pytest.raises(ValueError, match="output channels"):
        tk.tcn_plan(8, 20, 640, 640, 40, 1, False, torch.bfloat16)
    with pytest.raises(ValueError, match="time steps"):
        tk.tcn_plan(8, 40, 64, 64, 4, 1, False, torch.float32)
    with pytest.raises(TypeError):
        tk.tcn_plan(8, 20, 64, 64, 4, 1, False, torch.float16)


def test_a_level_without_its_packing_serves_on_the_cpu():
    lv = levels("flagship", torch.float32)[0]._replace(kw=None)
    # on the CPU the plain version serves a level without its packing
    x = torch.zeros(1, 20, 540)
    assert tk.tcn_level(x, lv).shape == (1, 20, 540)
