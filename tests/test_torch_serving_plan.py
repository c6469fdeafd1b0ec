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
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.models.wiflow import WiFlowPoseModel
from wiflow_tpu_torch.models.wiflow_mmfi import MMFiModelConfig, WiFlowMMFiModel
from wiflow_tpu_torch.ops.kernels import conv_stack as ck
from wiflow_tpu_torch.ops.kernels import tcn_level as tk
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT
from wiflow_tpu_torch.ops.kernels.fragments import to_fragments, to_wgmma_b
from wiflow_tpu_torch.utils import trace

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
SLACK = (64 + 4) * 16   # bytes after the bf16 kernel's regions
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
    C_out]`` fp32 matrix (empty for an elementwise conv), rows in the
    packing's order (fp32: tap-major, then the shortcut; bf16: the views of
    ``wgmma_steps``)."""
    chans = ck._chans(stack.blocks)
    shapes, _, _ = ck._stack_shapes(chans)
    bf16 = stack.wpack.dtype == torch.bfloat16
    if bf16:
        woffs, _ = ck._wgmma_woffs(chans)
        steps = ck.wgmma_steps(chans)
    out = []
    for k, sh in enumerate(shapes):
        mats = []
        for j, cs in enumerate(sh.convs):
            kp = 16 * (len(steps[k][j]) if bf16 else cs.ksteps)
            at = woffs[k][j] if bf16 else cs.woff
            f = stack.wpack[at:at + kp * sh.co].float().cpu()
            if bf16:
                f = from_wgmma_b(f, kp, sh.co)
            mats.append(f.reshape(kp, sh.co))
        out.append(mats)
    return out


def from_wgmma_b(f, kp, n):
    """The inverse of ``to_wgmma_b``, element by element: ``[K, N]``.
    Element ``(k, c)`` of k-step ``s = k // 16`` sits in the step's 8 x 8
    core matrix of column block ``c // 8`` and k half ``k % 16 // 8``, at
    row ``c % 8`` and position ``k % 8``."""
    k = torch.arange(kp)[:, None]
    c = torch.arange(n)[None, :]
    at = ((k // 16) * (16 * n) + (c // 8) * 128 + (k % 16 // 8) * 64
          + (c % 8) * 8 + k % 8)
    return f[at]


def unpack_level(lv):
    """``kw`` read back into the five matrices of ``level_matrices``."""
    cin, cout = lv.p1w.shape
    groups = lv.g1w.shape[1]
    bf16 = lv.kw.dtype == torch.bfloat16
    lay = tk._weight_layout(cin, cout, groups, lv.dw is not None, bf16)
    kw = lv.kw.float().cpu()
    shapes = [(groups, 16 * lay.ks[0], tk._cgp(cin // groups)),
              (groups, 16 * lay.ks[1], tk._cgp(cout // groups))] + [
        (16 * k, lay.ncols) for k in lay.ks[2:]]
    out = []
    for off, shape in zip(lay.offs, shapes):
        n = 1
        for d in shape:
            n *= d
        f = kw[off:off + n]
        if bf16 and n:
            if len(shape) == 3:
                per = n // shape[0]
                f = torch.stack([from_fragments(f[i * per:(i + 1) * per],
                                                *shape[1:])
                                 for i in range(shape[0])])
            else:
                f = from_wgmma_b(f, *shape)
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
        # a position's row: 16-byte words, an odd number of them
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


def check_wgmma_conv_plan(plan, rows, w0, chans, sms=132):
    """What ``csrc/conv_stack.cu::plan_ok_w`` and the bf16 kernel assume."""
    al = lambda v: -(-v // 16) * 16   # noqa: E731
    assert plan.path == "wgmma" and 2 <= plan.wgs <= 5
    nblk, nkst = len(chans), len(plan.ksteps)
    slack = (64 + 4) * 16      # views read past the last region
    fixed = (al(4 * plan.nvec) + al(2 * plan.wfrag)
             + al((3 * nblk * 16 + 2 * nkst) * 4) + slack)
    assert plan.smem == fixed + plan.wgs * plan.region <= SMEM_LIMIT
    # a warpgroup's region: its input rows (with the 16-byte slack of their
    # aligned cover), then its buffers
    r = plan.tile_rows
    assert plan.xbuf % 16 == 0 and plan.xbuf >= 2 * r * w0 + 32
    assert plan.region % 16 == 0 and plan.region > plan.xbuf
    # every row in exactly one tile, every tile in exactly one warpgroup:
    # warpgroup g of block b takes tiles b wgs + g, then grid wgs apart
    ntiles = -(-rows // r)
    assert plan.grid == min(sms, -(-ntiles // plan.wgs))
    seen = np.zeros(rows, np.int32)
    for b in range(plan.grid):
        for g in range(plan.wgs):
            for t in range(b * plan.wgs + g, ntiles, plan.grid * plan.wgs):
                seen[t * r:(t + 1) * r] += 1
    assert (seen == 1).all()
    # each row padded with a zero position at both ends; a stride-2
    # block's input in even and odd planes; a plane holds the tile's
    # positions, 16 bytes each
    w = w0
    for k, (ci, co, stride) in enumerate(chans):
        w = (w - 1) // stride + 1
        assert plan.widths[k] == w and plan.row_stride[k] == w + 2
        assert plan.planes[k] == stride
        assert plan.plane_bytes[k] == r * (w + 2) * 16
    # each block's buffers (input, h1, h2, output) inside the region, 16-byte
    # aligned, the output the next block's input, and no two of those live
    # at one conv (conv2: input, h1, h2; conv3: input, h2, output) overlap
    for k, (ci, co, _) in enumerate(chans):
        x_off, h1, h2, out = plan.buffers[k]
        pb = plan.plane_bytes[k]
        last = k == len(chans) - 1
        size = {"x": ci // 8 * plan.planes[k] * pb if k else 0,
                "h1": co // 8 * pb, "h2": co // 8 * pb,
                "out": (r * co * plan.widths[-1] * 2 if last else
                        co // 8 * plan.planes[k + 1] * plan.plane_bytes[k + 1])}
        at = {"x": x_off, "h1": h1, "h2": h2, "out": out}
        assert x_off == (plan.buffers[k - 1][3] if k else 0)
        for name in ("h1", "h2", "out"):
            assert at[name] % 16 == 0 and plan.xbuf <= at[name]
            assert at[name] + size[name] <= plan.region
        for live in (("x", "h1", "h2"), ("x", "h2", "out")):
            spans = sorted((at[n], at[n] + size[n]) for n in live
                           if size[n] and (n != "x" or k))
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert plan.dims[:3] == (plan.region, plan.xbuf, nkst)
    flat = [v for c in plan.convs for v in c] + [
        v for e in plan.ksteps for v in e]
    assert plan.dims[3:] == tuple(flat)
    n_wgmma = 0
    for i, c in enumerate(plan.convs):
        (kind, nt, ks, kf, woff, boff, mp, q, dst, dpb, dp, dq, wdoff, stride,
         w1off, co) = c
        k, j = divmod(i, 3)
        ci = chans[k][0]
        assert co == chans[k][1] == 8 * nt and nt <= 8
        assert q == plan.row_stride[k] and mp == r * q
        assert stride == chans[k][2] and boff + co <= plan.nvec
        assert plan.xbuf <= dst and dst % 16 == 0
        if kind == 1:
            # ConvBlock1's 1-channel conv, elementwise, into h1's planes
            assert i == 0 and ci == 1 and ks == 0 and dp == 1
            assert w1off + 3 * co <= plan.nvec
        else:
            n_wgmma += 1
            assert kind == 0 and ks >= 1 and kf + ks <= nkst
            assert woff % 16 == 0 and woff + 32 * co * ks <= 2 * plan.wfrag
            span = 64 * -(-mp // 64) * 16
            for a_off, lbo in plan.ksteps[kf:kf + ks]:
                assert a_off >= 0 and a_off % 16 == 0
                assert lbo >= 16 and lbo % 16 == 0 and lbo < 2 ** 18
                assert a_off + lbo + span <= plan.region + slack
        assert (wdoff >= 0) == (k == 0 and j == 2 and ci == 1)
        if i == len(plan.convs) - 1:
            # the stack's output staged [row][C][W]
            assert dp == 0 and dst + r * co * (q - 2) * 2 <= plan.region
        elif j < 2 or chans[k + 1][2] == 1:
            assert dp == 1 and dpb >= mp * 16
            assert dst + (co // 8) * dpb <= plan.region
        else:
            assert dp == 2 and dq == plan.row_stride[k + 1]
            assert (q - 1) // 2 < dq and dpb == plan.plane_bytes[k + 1]
            assert dst + 2 * (co // 8) * dpb <= plan.region
    assert plan.wgmma_convs == n_wgmma == 3 * nblk - 1


def check_plan(plan, rows, w0, chans, dtype, sms=132):
    if dtype == torch.bfloat16:
        check_wgmma_conv_plan(plan, rows, w0, chans, sms)
    else:
        check_conv_plan(plan, rows, w0, chans, dtype)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_plan_at_model_shapes(name, batch, dtype):
    cfg, _ = model(name)
    chans = ck._chans(stack(name, dtype))
    rows = batch * cfg.window_size
    plan = ck.conv_stack_plan(rows, conv_w0(name), chans, dtype)
    check_plan(plan, rows, conv_w0(name), chans, dtype)
    assert plan.widths[-1] == (15 if name == "flagship" else 17)
    if dtype == torch.bfloat16:
        # 14 convs a forward on wgmma: all but ConvBlock1's first
        assert plan.path == "wgmma" and plan.wgmma_convs == 14
        assert plan.wfrag > 40000
    if batch == 4096:
        # the grid is one block on each of the card's 132 SMs; bf16 keeps
        # every weight in shared memory beside 5 (MM-Fi: 4) warpgroups of 3
        # rows
        assert plan.grid == 132
        if dtype == torch.bfloat16:
            assert (plan.wgs, plan.tile_rows) == (
                (5, 3) if name == "flagship" else (4, 3))
        else:
            assert plan.blocks_per_sm == 1
    if name == "mmfi" and dtype == torch.bfloat16:
        # MM-Fi's smallest call, one sequence of 297 frames, still fills
        # the 132 SMs
        small = ck.conv_stack_plan(297 * cfg.window_size, conv_w0(name),
                                   chans, dtype)
        check_plan(small, 297 * cfg.window_size, conv_w0(name), chans,
                   dtype)
        assert small.grid == 132


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@settings(max_examples=40, deadline=None)
@given(batch=st.integers(1, 5000), name=st.sampled_from(MODELS),
       sms=st.sampled_from((1, 7, 132)))
def test_conv_stack_plan_any_batch(dtype, batch, name, sms):
    cfg, _ = model(name)
    chans = ck._chans(stack(name, dtype))
    rows = batch * cfg.window_size
    plan = ck.conv_stack_plan(rows, conv_w0(name), chans, dtype, sms)
    check_plan(plan, rows, conv_w0(name), chans, dtype, sms)
    assert plan.grid <= sms
    if dtype == torch.bfloat16 and sms == 132:
        # the tiles reach every SM where there are enough of them
        ntiles = -(-rows // plan.tile_rows)
        assert plan.grid == min(132, -(-ntiles // plan.wgs))


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


def view_rows(blk, j, view):
    """The test's own reading of a k-step view: the 8 K rows it stands
    for."""
    co = blk.w1.shape[2]
    if view is None:
        return torch.zeros(8, co)
    if view[0] == "short":
        return blk.wd.float()[8 * view[1]:8 * view[1] + 8]
    _, d, c = view
    return (blk.w1, blk.w2, blk.w3)[j].float()[d, 8 * c:8 * c + 8]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_packing_reads_back_to_the_taps(name, dtype):
    """Each conv's [K, C_out]: fp32 taps tap-major, conv3 followed by the
    strided shortcut's rows, zero padding to 16; bf16 the rows of its
    k-steps' views; the vectors hold b1, b2, b3 + e and a 1-channel
    block's taps."""
    st_ = stack(name, dtype)
    assert st_.wpack.dtype == dtype and st_.vec.dtype == torch.float32
    chans = ck._chans(st_)
    shapes, _, _ = ck._stack_shapes(chans)
    steps = ck.wgmma_steps(chans)
    for k, (blk, mats, sh) in enumerate(zip(st_, conv_k_matrices(st_),
                                            shapes)):
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
            if dtype == torch.bfloat16:
                rows = torch.cat([view_rows(blk, j, v) for pair in steps[k][j]
                                  for v in pair])
                assert torch.equal(got, rows)
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


@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_wgmma_b_reads_back_to_the_taps(name):
    """The bf16 packing, read back through wgmma's B order, holds each
    conv's k-steps one after another, 16 x C_out each: every tap chunk of
    the conv's source and every shortcut chunk exactly once, beside zero
    rows only where a view is None, and the k-steps fill the packing."""
    st_ = stack(name, torch.bfloat16)
    chans = ck._chans(st_)
    steps = ck.wgmma_steps(chans)
    woffs, total = ck._wgmma_woffs(chans)
    assert st_.wpack.numel() == total
    kw = st_.wpack.float().cpu()
    at = 0
    for k, blk in enumerate(st_):
        ci, co, _ = chans[k]
        for j in range(3):
            st = steps[k][j]
            if j == 0 and ci == 1:
                assert st == ()
                continue
            assert woffs[k][j] == at
            flat = kw[at:at + 16 * len(st) * co]
            got = from_wgmma_b(flat, 16 * len(st), co)
            assert torch.equal(to_wgmma_b(got), flat)
            views = [v for pair in st for v in pair]
            src = ci if j == 0 else co
            want = {("tap", d, c) for d in range(3) for c in range(src // 8)}
            if j == 2 and ci > 1:
                want |= {("short", c) for c in range(ci // 8)}
            assert sorted(v for v in views if v) == sorted(want)
            for i, v in enumerate(views):
                assert torch.equal(got[8 * i:8 * i + 8],
                                   view_rows(blk, j, v).to(torch.bfloat16)
                                   .float())
            # at most one view of zeros a source (an odd chunk count)
            assert views.count(None) <= 2
            at += 16 * len(st) * co
    assert at == total


def plan_sources(plan):
    """Per conv (bytes into the region, planes, plane bytes, positions a
    row) of the buffer its taps read, and of the block's input for conv3's
    shortcut."""
    out = []
    for i in range(len(plan.convs)):
        k, j = divmod(i, 3)
        src = plan.convs[i - 1][8] if i else 0
        par = plan.planes[k] if j == 0 else 1
        x_k = plan.convs[3 * k - 1][8] if k else 0
        out.append(((src, par, plan.plane_bytes[k], plan.row_stride[k]),
                    (x_k, plan.planes[k], plan.plane_bytes[k],
                     plan.row_stride[k])))
    return out


def write_layout(region, buf, x):
    """x ``[R, C, W]`` into a region (bf16 elements as floats) as the
    kernel lays it out: rows padded with a zero position at both ends,
    position-major planes of 8 channels, even and odd planes where the
    buffer has 2."""
    off, par, pb, q = buf
    r, c, w = x.shape
    xp = F.pad(x, (1, 1))                        # [R, C, W + 2]
    for p in range(w + 2):
        plane = (par * (torch.arange(c) // 8) + (p % 2 if par == 2 else 0))
        pos = torch.arange(r)[:, None] * q + (p // 2 if par == 2 else p)
        byte = (off + plane[None] * pb + pos * 16
                + (torch.arange(c) % 8)[None] * 2)
        region[byte // 2] = xp[:, :, p]


def gather_views(region, kst, mp):
    """A ``[64 m-tiles, 16 ks]``: each k-step's two core-matrix columns of
    8 channels, read by descriptor (position m at +16 m bytes, the second
    view LBO bytes after the first)."""
    m = torch.arange(64 * -(-mp // 64))
    cols = []
    for a_off, lbo in kst:
        for base in (a_off, a_off + lbo):
            idx = (base + m[:, None] * 16) // 2 + torch.arange(8)[None, :]
            cols.append(region[idx])
    return torch.cat(cols, dim=1)


@pytest.mark.parametrize("rows", (1, 140, 81920))
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_shifted_views_read_the_taps(name, rows):
    """A torch mirror of the bf16 layout: each GEMM conv's A, gathered by
    the plan's descriptors from its source (and the block's input for the
    shortcut) laid out padded and, for a stride-2 block, de-interleaved,
    times its packed B equals F.conv2d's taps (and the strided 1x1) at
    every row's real positions; stride 1 and 2."""
    gen = torch.Generator().manual_seed(5)
    st_ = stack(name, torch.float32)
    chans = ck._chans(st_)
    plan = ck.conv_stack_plan(rows, conv_w0(name), chans, torch.bfloat16)
    steps = ck.wgmma_steps(chans)
    r = plan.tile_rows
    for i, (src, xin) in enumerate(plan_sources(plan)):
        k, j = divmod(i, 3)
        ci, co, stride = chans[k]
        if plan.convs[i][0] == 1:
            continue
        blk = st_.blocks[k]
        region = torch.randn((plan.region + SLACK) // 2,
                             generator=gen)           # stale data
        w_in = plan.widths[k - 1] if k else conv_w0(name)
        wo = plan.widths[k]
        x = torch.randn(r, ci, w_in, generator=gen)
        h = torch.randn(r, co, wo, generator=gen)
        write_layout(region, xin, x)
        if j:
            write_layout(region, src, h)
        (_, _, ks, kf, _, _, mp, q, *_rest) = plan.convs[i]
        a = gather_views(region, plan.ksteps[kf:kf + ks], mp)
        got = (a @ ck.wgmma_k_matrix(blk, j, steps[k][j]))[:mp]
        got = got.reshape(r, q, co)[:, 1:-1].permute(0, 2, 1)
        w = (blk.w1, blk.w2, blk.w3)[j].float()      # [3, Ci, Co]
        inp, s = (x, stride) if j == 0 else (h, 1)
        ref = F.conv2d(inp[:, :, None], w.permute(2, 1, 0)[:, :, None],
                       stride=(1, s), padding=(0, 1))[:, :, 0]
        if j == 2 and ci > 1:   # a 1-channel shortcut is the epilogue's
            ref = ref + torch.einsum("riw,io->row", x[:, :, ::stride],
                                     blk.wd.float())
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def mirror_stack(plan, blocks, x):
    """The whole bf16 plan run by a torch mirror in fp32 (no rounding): one
    warpgroup's tile of ``x`` ``[<= R, W0]`` through its region, conv by
    conv as the kernel addresses it."""
    chans = ck._chans(blocks)
    steps = ck.wgmma_steps(chans)
    shapes, _, _ = ck._stack_shapes(chans)
    r, w0 = plan.tile_rows, x.shape[1]
    region = torch.zeros((plan.region + SLACK) // 2)
    region[:x.numel()] = x.reshape(-1)
    vec = torch.zeros(plan.nvec)
    for blk, sh in zip(blocks, shapes):
        for j, cs in enumerate(sh.convs):
            vec[cs.boff:cs.boff + sh.co] = (blk.b1, blk.b2,
                                            blk.b3 + blk.bd)[j].float()
        if sh.w1off >= 0:
            vec[sh.w1off:sh.w1off + 3 * sh.co] = blk.w1.float().reshape(-1)
            vec[sh.wdoff:sh.wdoff + sh.co] = blk.wd.float().reshape(-1)
    for i, c in enumerate(plan.convs):
        (kind, nt, ks, kf, _, boff, mp, q, dst, dpb, dp, dq, wdoff, stride,
         w1off, co) = c
        k, j = divmod(i, 3)
        m = torch.arange(mp)
        row, pos = m // q, m % q
        pad = (pos == 0) | (pos == q - 1)

        def x_at(p):
            ok = (~pad) & (p >= 0) & (p < w0)
            return torch.where(ok, region[(row * w0 + p).clamp(0, r * w0 - 1)],
                               0.0)
        if kind == 1:
            w1 = vec[w1off:w1off + 3 * co].reshape(3, co)
            v = vec[boff:boff + co] + sum(
                x_at(stride * (pos - 1) + d - 1)[:, None] * w1[d]
                for d in range(3))
        else:
            a = gather_views(region, plan.ksteps[kf:kf + ks], mp)
            v = (a @ ck.wgmma_k_matrix(blocks[k], j, steps[k][j]))[:mp]
            v = v + vec[boff:boff + co]
            if wdoff >= 0:
                v = v + x_at(stride * (pos - 1))[:, None] * vec[
                    wdoff:wdoff + co]
        v = F.silu(v)
        v[pad] = 0
        ch = torch.arange(co)[None]
        if dp == 0:
            ok = ~pad
            at = dst // 2 + (row[ok, None] * co + ch) * (q - 2) + pos[ok, None] - 1
            region[at] = v[ok]
        else:
            if dp == 1:
                byte = dst + m * 16
            else:
                byte = dst + (pos % 2) * dpb + (row * dq + pos // 2) * 16
            region[byte[:, None] // 2 + (ch // 8) * (dp * dpb // 2)
                   + ch % 8] = v
    co, wl = chans[-1][1], plan.widths[-1]
    last = plan.convs[-1][8] // 2
    return region[last:last + r * co * wl].reshape(r, co, wl)[:x.shape[0]]


@pytest.mark.parametrize("w0,rows", ((None, 140), (None, 81920), (33, 300),
                                     (17, 7)))
@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_wgmma_mirror_matches_the_plain_stack(name, w0, rows):
    """The bf16 plan end to end in a torch mirror (its region, its
    k-step table, its epilogues' writes, the pads, the planes, the staged
    output) equals the plain stack in fp32, at the models' widths and at
    odd ones."""
    gen = torch.Generator().manual_seed(6)
    st_ = stack(name, torch.float32)
    w0 = w0 or conv_w0(name)
    plan = ck.conv_stack_plan(rows, w0, ck._chans(st_), torch.bfloat16)
    x = torch.randn(plan.tile_rows, w0, generator=gen)
    got = mirror_stack(plan, st_.blocks, x)
    torch.testing.assert_close(got, ck.conv_stack_plain(x, st_.blocks),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_conv_stack_wgmma_convs_counted_per_forward(name, monkeypatch):
    """``serve.conv_stack_wgmma_convs`` and ``conv_stack.wgmma_convs`` count
    14 convs a bf16 forward of either model (ConvBlock1's conv2 and conv3,
    3 in each stride-2 block), the launch stubbed: CPU tensors taken down
    the CUDA wrapper to a C entry point that returns success."""
    from wiflow_tpu_torch.models import fast
    _, sd = model(name)
    monkeypatch.setattr(ck, "fused_conv_stack_eval", ck._launch)
    monkeypatch.setattr(fast, "fused_conv_stack_eval", ck._launch)
    monkeypatch.setattr(ck, "sm_count", lambda index: 132)
    monkeypatch.setattr(ck, "stream_ptr", lambda device: None)
    monkeypatch.setattr(ck.KERNEL, "_fn", lambda *args: 0)
    monkeypatch.setattr(ck, "wgmma_convs", 0)
    if name == "flagship":
        packed = fast.pack_fast(sd, ModelConfig(), device="cpu")
        run, x = fast.fast_forward, torch.zeros(2, 540, 20)
    else:
        packed = fast.pack_fast_mmfi(sd, MMFiModelConfig(), device="cpu")
        run, x = fast.fast_forward_mmfi, torch.zeros(2, 3, 114, 10)
    launches = ck.KERNEL.launches
    trace.collect()
    trace.enable()
    try:
        for _ in range(2):
            run(packed, x)
    finally:
        trace.disable()
    counts = trace.collect().counts
    assert counts["serve.conv_stack_wgmma_convs"] == 2 * 14
    assert ck.wgmma_convs == 2 * 14
    assert ck.KERNEL.launches - launches == 2
    # fp32 runs on the CUDA cores: nothing counted
    packed32 = (fast.pack_fast if name == "flagship" else fast.pack_fast_mmfi)(
        sd, ModelConfig(compute_dtype="float32") if name == "flagship"
        else MMFiModelConfig(compute_dtype="float32"), device="cpu")
    run(packed32, x)
    assert ck.wgmma_convs == 2 * 14


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
    """What ``csrc/tcn_level.cu::plan_ok_wgmma`` / ``plan_ok_fma`` and the
    kernel assume."""
    esize = 2 if dtype == torch.bfloat16 else 4
    assert plan.path == ("wgmma" if esize == 2 else "fma")
    (b, t, ci, co, g, d, samples) = plan.dims[:7]
    assert (b, t, ci, co, g, d) == (batch, steps, cin, cout, groups, dil)
    assert plan.smem <= SMEM_LIMIT
    assert plan.blocks_per_sm * plan.smem <= SMEM_LIMIT
    # whole samples a tile, padded to the tensor cores' rows: one wgmma
    # M of 64 in bf16, two 16-row m-tiles in fp32
    assert samples == plan.samples and samples * steps <= plan.rows
    assert plan.rows == (64 if esize == 2 else 32)
    ntm = -(-batch // samples)
    grid = plan.dims[17 if esize == 2 else 21]
    assert grid == plan.grid and 1 <= grid <= ntm
    seen = np.zeros(batch, np.int32)
    for blk in range(grid):
        for tile in range(blk, ntm, grid):
            seen[tile * samples:(tile + 1) * samples] += 1
    assert (seen == 1).all()
    ntiles = -(-cout // 8)
    al = lambda v: -(-v // 16) * 16   # noqa: E731
    if esize == 2:
        check_wgmma_plan(plan, cin, cout, groups, has_d, ntiles, al)
    else:
        check_fma_plan(plan, cin, cout, groups, has_d, ntiles, al)


def check_wgmma_plan(plan, cin, cout, groups, has_d, ntiles, al):
    (nch_in, nch_out, kbuf, nt, stages, ks_g1, ks_g2, ks_p1, ks_p2, ks_d,
     grid, smem, off_g1, off_g2, off_p1, off_p2, off_d) = plan.dims[7:]
    assert smem == plan.smem and stages == plan.stages and nt == plan.ntw
    # a group's window: the 8-channel chunks of the dense layout that its
    # channels touch, 3 taps of them in whole 16-deep k-steps
    for nch, c in ((nch_in, cin), (nch_out, cout)):
        cg = c // groups
        spans = [(i * cg + cg - 1) // 8 - i * cg // 8 + 1
                 for i in range(groups)]
        assert nch == max(spans) <= -(-(cg + 7) // 8)
    assert (ks_g1, ks_g2) == (-(-3 * nch_in // 2), -(-3 * nch_out // 2))
    # three warpgroups of 8 nt columns (nt a multiple of 4, one kernel
    # each) cover C_out, one wgmma each (N <= 256)
    assert nt == 4 * -(-ntiles // 12) and 4 <= nt <= 24 and 24 * nt >= cout
    assert nt % 4 == 0 and 24 * nt - cout < 96
    assert (ks_p1, ks_p2, ks_d) == (-(-cin // 16), -(-cout // 16),
                                    -(-cin // 16) if has_d else 0)
    # the swizzled buffers: whole 64-channel atoms, wide enough for every
    # k-step the products read
    assert kbuf % 64 == 0 and kbuf >= max(16 * ks_p1, 16 * ks_p2)
    assert kbuf - 64 < max(cin, cout) <= kbuf
    # the weight stream: G1, G2, then P1, P2, D back to back, each k-step
    # (a ring slot) whole and 16-byte aligned for the bulk copies
    npad = 24 * nt
    g1 = groups * ks_g1 * 16 * tk._cgp(cin // groups)
    g2 = groups * ks_g2 * 16 * tk._cgp(cout // groups)
    step = 16 * npad
    assert (off_g1, off_g2, off_p1) == (0, g1, g1 + g2)
    assert off_p2 == off_p1 + ks_p1 * step and off_d == off_p2 + ks_p2 * step
    assert (off_p1 * 2) % 16 == 0 and (step * 2) % 256 == 0
    # the ring: as many slots as fit, 2 to 8
    al4 = lambda v: -(-v // 4) * 4   # noqa: E731
    fixed = 2 * kbuf * 128 + al(4 * (al4(cin) + al4(cout) + (
        3 if has_d else 2) * npad)) + 16 + 1024
    assert 2 <= stages <= 8
    assert smem == fixed + stages * (32 * npad + 16)
    assert stages == 8 or smem + 32 * npad + 16 > SMEM_LIMIT


def check_fma_plan(plan, cin, cout, groups, has_d, ntiles, al):
    (cgp_in, cgp_out, ldg_in, ldd_in, ldg_out, ldd_out, buf0, buf1, nti,
     ks_g1, ks_g2, ks_p1, ks_p2, ks_d, grid, smem, off_g1, off_g2, off_p1,
     off_p2, off_d) = plan.dims[7:]
    assert smem == plan.smem
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
    assert nti == ntiles and plan.ntw * 8 >= ntiles
    assert plan.ntw <= 9
    assert (ks_p1, ks_p2, ks_d) == (-(-cin // 16), -(-cout // 16),
                                    -(-cin // 16) if has_d else 0)
    assert (ks_g1, ks_g2) == (-(-3 * cgp_in // 16), -(-3 * cgp_out // 16))
    # the weights: G1, G2, then P1, P2, D back to back
    g1 = groups * ks_g1 * 16 * cgp_in
    g2 = groups * ks_g2 * 16 * cgp_out
    step = ntiles * 8 * 16
    assert (off_g1, off_g2, off_p1) == (0, g1, g1 + g2)
    assert off_p2 == off_p1 + ks_p1 * step and off_d == off_p2 + ks_p2 * step
    assert (off_p1 * 4) % 16 == 0 and (step * 4) % 16 == 0
    assert plan.stages == 0
    assert smem == al(plan.rows * buf0 * 4) + al(
        plan.rows * buf1 * 4) + 32 + al(2 * (cin + cout))


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
    """G1, G2: per group, tap j's input channel i at row j cgp + i (fp32),
    or at row 8 j nch + o + i of the group's window over the dense layout,
    o its first channel's place in its first chunk (bf16); P1, P2, D: the
    [C_in, C_out] matrix; zero wherever padded."""
    for lv in levels(name, dtype):
        assert lv.kw is not None and lv.kw.dtype == dtype
        g1, g2, p1, p2, d = unpack_level(lv)
        for got, taps in ((g1, lv.g1w), (g2, lv.g2w)):
            _, groups, ci, co = taps.shape
            cgp = got.shape[2]
            assert got.shape[0] == groups and cgp % 8 == 0
            want = torch.zeros_like(got)
            for g in range(groups):
                for j in range(3):
                    if dtype == torch.bfloat16:
                        nch = tk._window_chunks(ci, groups)
                        r = 8 * j * nch + g * ci - g * ci // 8 * 8
                    else:
                        r = j * cgp
                    want[g, r:r + ci, :co] = taps[j, g].float()
            assert torch.equal(got, want)
        for got, w in ((p1, lv.p1w), (p2, lv.p2w), (d, lv.dw)):
            if w is None:
                assert got.numel() == 0
                continue
            k, n = w.shape
            assert got.shape[0] % 16 == 0 and got.shape[1] % 8 == 0
            assert torch.equal(got[:k, :n], w.float())
            assert not got[k:].any() and not got[:, n:].any()


@pytest.mark.parametrize("name", MODELS)
def test_tcn_wgmma_b_reads_back_to_the_products(name):
    """The bf16 ring's k-steps, read back through wgmma's B order, are the
    [K, C_out] matrices of P1, P2 and D, C_out padded to three warpgroups
    of 8 NT columns (NT a multiple of 4), and each k-step is one
    contiguous slot."""
    for lv in levels(name, torch.bfloat16):
        cin, cout = lv.p1w.shape
        groups = lv.g1w.shape[1]
        lay = tk._weight_layout(cin, cout, groups, lv.dw is not None, True)
        assert lay.ncols == 96 * -(-(-(-cout // 8)) // 12)
        kw = lv.kw.float().cpu()
        for at, ks, w in zip(lay.offs[2:], lay.ks[2:],
                             (lv.p1w, lv.p2w, lv.dw)):
            if w is None:
                assert ks == 0
                continue
            k, n = w.shape
            assert ks == -(-k // 16)
            flat = kw[at:at + 16 * ks * lay.ncols]
            got = from_wgmma_b(flat, 16 * ks, lay.ncols)
            assert torch.equal(got[:k, :n], w.float())
            assert not got[k:].any() and not got[:, n:].any()
            # a slot's core matrix (block 1, k half 1) holds columns 8-15
            # of rows 8-15 of the step, column by column
            step = flat[:16 * lay.ncols]
            core = step[128 + 64:128 + 128].reshape(8, 8)
            assert torch.equal(core, got[8:16, 8:16].t())


@pytest.mark.parametrize("batch", (1, 2, 3, 7, 64, 1001, 4095, 4096))
@pytest.mark.parametrize("name", MODELS)
def test_tcn_plan_takes_wgmma_for_every_bf16_level(name, batch):
    """Every bf16 level of both models runs its products on wgmma, fp32 on
    the CUDA cores, at any batch."""
    cfg, _ = model(name)
    for i, cin, cout in level_cases(name):
        args = (batch, cfg.window_size, cin, cout, cfg.tcn_groups, 2 ** i,
                cin != cout)
        assert tk.tcn_plan(*args, torch.bfloat16).path == "wgmma"
        assert tk.tcn_plan(*args, torch.float32).path == "fma"


@pytest.mark.parametrize("name", MODELS)
def test_tcn_window_conv_mirror_matches_the_grouped_conv(name):
    """A torch mirror of the bf16 kernel's grouped conv (each group's
    window of chunks over the dense layout, the causal shift, the zero row
    past the last chunk) on the packed weights equals the plain grouped
    conv."""
    gen = torch.Generator().manual_seed(4)
    cfg, _ = model(name)
    for lv in levels(name, torch.bfloat16)[:2]:
        g1 = unpack_level(lv)[0]
        w = lv.g1w.float()
        _, groups, ci, _ = w.shape
        cin, t, d = groups * ci, cfg.window_size, lv.dilation
        nch = tk._window_chunks(ci, groups)
        nchunks = -(-cin // 8)
        x = torch.randn(3, t, cin, generator=gen)
        ref = tk._grouped_causal_plain(x, w, d)
        xp = F.pad(x, (0, 8 * (nchunks + nch) - cin))
        got = torch.zeros_like(ref)
        for g in range(groups):
            rows = []
            for q in range(g1.shape[1] // 8):
                j, k = divmod(q, nch)
                chunk = g * ci // 8 + k
                shift = (2 - j) * d
                if j >= 3 or chunk >= nchunks:
                    rows.append(torch.zeros(3, t, 8))
                    continue
                seg = xp[:, :, 8 * chunk:8 * chunk + 8]
                rows.append(F.pad(seg, (0, 0, shift, 0))[:, :t])
            a = torch.cat(rows, dim=2)               # [B, T, 16 ks]
            got[:, :, g * ci:(g + 1) * ci] = (a @ g1[g])[:, :, :ci]
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_wgmma_levels_counted_per_forward(name, monkeypatch):
    """``serve.tcn_wgmma_levels`` and ``tcn_level.wgmma_levels`` count 4
    levels a bf16 ``fast_forward`` and 3 a ``fast_forward_mmfi``, the
    launch stubbed: CPU tensors taken down the CUDA wrapper to a C entry
    point that returns success."""
    from wiflow_tpu_torch.models import fast
    _, sd = model(name)
    monkeypatch.setattr(tk, "tcn_level", tk._launch)
    monkeypatch.setattr(tk, "sm_count", lambda index: 132)
    monkeypatch.setattr(tk, "stream_ptr", lambda device: None)
    monkeypatch.setattr(tk.KERNEL, "_fn", lambda *args: 0)
    monkeypatch.setattr(tk, "wgmma_levels", 0)
    if name == "flagship":
        packed = fast.pack_fast(sd, ModelConfig(), device="cpu")
        run, x, per = fast.fast_forward, torch.zeros(2, 540, 20), 4
    else:
        packed = fast.pack_fast_mmfi(sd, MMFiModelConfig(), device="cpu")
        run, x, per = fast.fast_forward_mmfi, torch.zeros(2, 3, 114, 10), 3
    launches = tk.KERNEL.launches
    trace.collect()
    trace.enable()
    try:
        for _ in range(2):
            run(packed, x)
    finally:
        trace.disable()
    counts = trace.collect().counts
    assert counts["serve.tcn_wgmma_levels"] == 2 * per
    assert tk.wgmma_levels == 2 * per
    assert tk.KERNEL.launches - launches == 2 * per


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
