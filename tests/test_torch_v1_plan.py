"""The launch plan and the staging of the v1 attention kernel, held on the
CPU.

``ops/kernels/axial_attention.py::v1_plan`` is a pure function of the
shapes, the dtype and the SM count; the kernel
(``csrc/axial_attention_v1.cu``) runs on the card only, so what can be
held here is that every plan is one the kernel accepts: whole sequences of
at most 80 positions a tile, the core's items covered by the block's
threads, the shared memory laid out as the C side lays it out (one fp32
q, k, v tile, one raw tile and its mbarrier) within the card's limit and
the blocks an SM it states, and a persistent grid whose blocks, walking
tiles ``x, x + grid, ...`` through the raw tile and its mbarrier's
phases, take every sequence exactly once.

And that the move of a landed raw row into the fp32 layout (``settle_tile``:
a 16-byte chunk onto runs of 4 floats of ``QkvLayout::at``) puts every q,
k and v channel in a slot of its own, the slot the earlier staging
(straight from device memory) used and the core reads: a torch mirror of
the kernel's addressing, staging, move, core reads and stores, held
against the plain version.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.ops.kernels import axial_attention as ak
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (H, W) of the attention: the flagship's 15 keypoints x 20 steps, MM-Fi's
# 17 x 10; both C = 64 in 8 groups
SHAPES = {"flagship": (15, 20), "mmfi": (17, 10)}
C, G = 64, 8
SM_SMEM, RESERVED = 233472, 1024
MAX_THREADS, MAX_POSITIONS = 320, 80


def esize(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def blocks_per_sm(smem, threads):
    """Blocks an SM: its shared memory, and its registers at the ~102 a
    thread that ``__launch_bounds__(320, 2)`` allows."""
    if smem > SMEM_LIMIT:
        return 0
    return min(SM_SMEM // (smem + RESERVED),
               65536 // (65536 // (2 * MAX_THREADS) * threads))


def ring_schedule(ap):
    """Mirror of the kernel's loop, for every block of the grid: before
    the loop the block's first tile is staged into the raw tile; each turn
    waits for the parity of the mbarrier phase that brings the next tile
    (0, 1, 0, ...), moves that tile out, and stages the tile a grid on,
    whose bytes complete the next phase.  Returns how often each tile was
    moved."""
    moved = np.zeros(ap.tiles, int)
    for x in range(ap.grid):
        staged = [x]             # staged[i]: the tile that completes phase i
        for i, tile in enumerate(range(x, ap.tiles, ap.grid)):
            assert staged[i] == tile   # the wait for parity i % 2
            moved[tile] += 1
            if tile + ap.grid < ap.tiles:
                staged.append(tile + ap.grid)
        # no copy is left in flight when the block ends
        assert len(staged) == len(range(x, ap.tiles, ap.grid))
    return moved


def core_threads(seqs, length, groups):
    """The core's items (2 queries of one group) in whole warps, 128-320."""
    items = seqs * -(-length // 2) * groups
    return max(128, min(MAX_THREADS, -(-items // 32) * 32))


def check_axis_plan(ap, batch, length, other, c, groups, dtype, sms):
    """One v1 launch along an axis of ``length`` (``other`` the other)."""
    nseq = batch * other
    npos = ap.seqs * length
    # whole sequences, at most 80 positions: as many as fit the card
    most = max(1, MAX_POSITIONS // length)
    assert ap.length == length and 1 <= ap.seqs <= most
    assert npos <= MAX_POSITIONS or ap.seqs == 1
    if ap.seqs < most:
        more = ((ap.seqs + 1) * length
                * ((3 * c + 24) * 4 + 3 * c * esize(dtype)) + 8)
        assert blocks_per_sm(more, core_threads(ap.seqs + 1, length,
                                                groups)) == 0
    assert ap.threads == core_threads(ap.seqs, length, groups)
    # as csrc/axial_attention_v1.cu::layout lays it out: the fp32 tile,
    # rows of 3C + 24 floats, then the raw tile, [npos][3C], then its
    # 8-byte mbarrier; each part 16-byte aligned for the bulk copies and
    # float4 stores
    assert ap.layout == (npos * (3 * c + 24) * 4, npos * 3 * c * esize(dtype),
                         8)
    assert ap.layout[0] % 16 == 0 and ap.layout[1] % 16 == 0
    assert ap.smem == sum(ap.layout) <= SMEM_LIMIT
    assert ap.blocks_per_sm == blocks_per_sm(ap.smem, ap.threads) >= 1
    # every sequence in exactly one tile, every tile settled exactly once
    # by the persistent grid
    assert ap.tiles == -(-nseq // ap.seqs)
    assert ap.grid == min(ap.tiles, ap.blocks_per_sm * sms)
    assert (ring_schedule(ap) == 1).all()
    starts = np.arange(ap.tiles) * ap.seqs
    assert (np.minimum(ap.seqs, nseq - starts) >= 1).all()
    assert starts[-1] + ap.seqs >= nseq


@pytest.mark.parametrize("sms", (1, 66, 132))
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", (4096, 256, 7))
@pytest.mark.parametrize("shape", SHAPES)
def test_v1_plan_at_the_models_axes(shape, batch, dtype, sms):
    h, w = SHAPES[shape]
    p = ak.v1_plan(batch, h, w, C, G, dtype, sms)
    check_axis_plan(p.width, batch, w, h, C, G, dtype, sms)
    check_axis_plan(p.height, batch, h, w, C, G, dtype, sms)
    if dtype == torch.bfloat16:
        # an fp32 tile and one raw tile: ~100 KB, two blocks an SM
        assert p.width.blocks_per_sm == p.height.blocks_per_sm == 2
        assert p.width.smem <= 100_000
    if batch == 4096 and sms == 132:
        # the last round of the persistent grid is part-filled on both
        # axes: the blocks walk unequal numbers of tiles
        for ap in p:
            assert ap.grid == ap.blocks_per_sm * 132 and ap.tiles % ap.grid


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("length", range(1, 33))
def test_v1_plan_at_every_length(length, dtype):
    for sms in (1, 66, 132):
        for batch in (7, 256):
            p = ak.v1_plan(batch, length, length, C, G, dtype, sms)
            for ap in p:
                check_axis_plan(ap, batch, length, length, C, G, dtype, sms)


@pytest.mark.parametrize("c", (8, 32, 128, 256))
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_v1_plan_at_other_widths(dtype, c):
    p = ak.v1_plan(64, 15, 20, c, c // 8, dtype, 132)
    check_axis_plan(p.width, 64, 20, 15, c, c // 8, dtype, 132)
    check_axis_plan(p.height, 64, 15, 20, c, c // 8, dtype, 132)
    # 80 positions up to C = 128 in bf16, fewer where they do not fit
    assert (p.width.seqs == 4) == (c <= 64 or (c == 128 and
                                               dtype == torch.bfloat16))


@pytest.mark.parametrize("bad, error", [
    (dict(groups=4), ValueError),            # C != 8 G
    (dict(h=33), ValueError),                # L > 32
    (dict(w=40), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(c=1024, groups=128), ValueError),  # one sequence exceeds the card
])
def test_v1_plan_refuses_what_the_kernel_cannot_take(bad, error):
    args = dict(batch=7, h=15, w=20, c=C, groups=G, dtype=torch.bfloat16)
    args.update(bad)
    with pytest.raises(error) as info:
        ak.v1_plan(**args)
    if args["c"] == 1024:
        # the sizes in the message
        assert "20 positions" in str(info.value)
        assert str(SMEM_LIMIT) in str(info.value)


# ---------------------------------------------------------------------------
# the staging, mirrored
# ---------------------------------------------------------------------------

def layout_at(c, s, g, cc):
    """``QkvLayout::at``: the float of channel ``cc`` (0-7) of group ``g``
    in section ``s`` (0 q, 1 k, 2 v) of a row of ``3C + 24`` floats."""
    return s * (c + 8) + (cc >> 2) * (c // 2 + 4) + 4 * g + (cc & 3)


def settle_slots(c, dtype):
    """Where ``settle_tile`` puts each element of a raw row ``[3C]``: chunk
    ``e`` of 16 bytes holds columns ``e kVec ...``, section ``(col >= C) +
    (col >= 2C)``, and lands as runs of 4 floats."""
    kvec = 16 // esize(dtype)
    slots = np.full(3 * c, -1)
    for e in range(3 * c // kvec):
        col = e * kvec
        sec = int(col >= c) + int(col >= 2 * c)
        r = col - sec * c
        for k in range(0, kvec, 4):
            base = layout_at(c, sec, r // 8, r % 8 + k)
            assert base % 4 == 0                  # one float4 store
            slots[col + k:col + k + 4] = base + np.arange(4)
    return slots


def parent_slots(c, dtype):
    """Where the earlier staging put each column of a row it loaded
    straight from device memory (section ``col / C``)."""
    kvec = 16 // esize(dtype)
    slots = np.full(3 * c, -1)
    for col in range(0, 3 * c, kvec):
        sec, r = col // c, col % c
        for k in range(0, kvec, 4):
            slots[col + k:col + k + 4] = (layout_at(c, sec, r // 8, r % 8 + k)
                                          + np.arange(4))
    return slots


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("c", (8, 24, 64, 128))
def test_settle_puts_every_channel_in_one_slot(c, dtype):
    slots = settle_slots(c, dtype)
    # every q, k, v channel in a slot of its own within the row, the slot
    # the earlier staging used and the core reads (channel cc of group g
    # of section s at QkvLayout::at), the 8 padding floats a section left
    assert (slots >= 0).all() and len(set(slots)) == 3 * c
    assert np.array_equal(slots, parent_slots(c, dtype))
    want = [layout_at(c, s, ch // 8, ch % 8)
            for s in range(3) for ch in range(c)]
    assert np.array_equal(slots, want)
    assert slots.max() < 3 * c + 24
    assert (3 * c + 24) * 4 % 16 == 0         # rows keep float4 alignment


def mirror_v1(qkv, sim, oaff, width, ap):
    """The kernel's work in torch: each block of the persistent grid walks
    its tiles, copies each valid sequence's raw rows through the sequence
    strides (in positions, as ``_launch_v1`` passes them), moves them into
    the fp32 layout by ``settle_slots``, reads q, k, v where the core reads
    them, and stores each output where the core's ``dst`` points.  Returns
    the output and how often each output element was written."""
    b, h, w, c3 = qkv.shape
    c, g = c3 // 3, sim.shape[1]
    n_inner, inner, seq = (h, w, 1) if width else (w, 1, w)
    outer, nseq, length = h * w, b * n_inner, ap.length
    flat = qkv.reshape(-1, c3)
    out = torch.zeros(b * h * w * c, dtype=torch.float32)
    writes = torch.zeros(b * h * w * c, dtype=torch.int64)
    slots = torch.from_numpy(settle_slots(c, qkv.dtype))
    reads = torch.tensor([[[layout_at(c, s, gg, cc) for cc in range(8)]
                           for gg in range(g)] for s in range(3)])
    ch = torch.arange(c).reshape(g, 8)
    for x in range(ap.grid):
        for tile in range(x, ap.tiles, ap.grid):
            s0 = tile * ap.seqs
            nvalid = min(ap.seqs, nseq - s0)
            s = s0 + torch.arange(nvalid)[:, None]
            pos = (s // n_inner * outer + s % n_inner * inner
                   + torch.arange(length)[None] * seq)      # [nvalid, L]
            fp32 = torch.zeros(nvalid * length, 3 * c + 24)
            fp32[:, slots] = flat[pos.reshape(-1)].float()
            fp32 = fp32.reshape(nvalid, length, -1)
            q, k, v = (fp32[:, :, reads[i]] for i in range(3))   # [n,L,G,8]
            lg = torch.einsum("nigc,njgc->ngij", q, k)
            lg = lg * sim[0][None, :, None, None] + sim[1][None, :, None, None]
            o = torch.einsum("ngij,njgc->nigc", torch.softmax(lg, -1), v)
            o = o * oaff[0][ch] + oaff[1][ch]
            dst = pos[:, :, None, None] * c + ch                 # [n,L,G,8]
            out[dst.reshape(-1)] = o.reshape(-1)
            writes[dst.reshape(-1)] += 1
    return out.reshape(b, h, w, c).to(qkv.dtype), writes


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("width", (True, False), ids=("width", "height"))
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_of_the_kernel_matches_plain(shape, width, dtype):
    # 3 samples on a few SMs: several blocks, each walking several tiles,
    # the last round of the grid and the last tile part-filled
    h, w = SHAPES[shape]
    sms = {"flagship": 5, "mmfi": 3}[shape]
    rng = np.random.default_rng(11 + h + 2 * width)
    qkv = torch.from_numpy(rng.standard_normal((3, h, w, 3 * C))
                           .astype(np.float32)).to(dtype)
    sim = torch.from_numpy(np.stack([0.5 + rng.random(G),
                                     rng.standard_normal(G)])
                           .astype(np.float32))
    oaff = torch.from_numpy(np.stack([0.5 + rng.random(C),
                                      rng.standard_normal(C)])
                            .astype(np.float32))
    plan = ak.v1_plan(3, h, w, C, G, dtype, sms)
    ap = plan.width if width else plan.height
    assert ap.tiles > ap.grid and ap.tiles % ap.grid
    got, writes = mirror_v1(qkv, sim, oaff, width, ap)
    assert (writes == 1).all()
    ref = ak.axial_attention_v1_plain(qkv, sim, oaff, width)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL * ref.float().abs().max().item()
