"""The launch plan and the shared-memory layout of the train attention
core, held on the CPU.

``ops/kernels/axial_attention_train.py::train_attention_plan`` is a pure
function of the shapes, the dtype and the SM count; the kernels
(``csrc/axial_core.cu``) run on the card only, so what can be held here is
that every plan is one the kernels accept: every sequence in exactly one
tile of whole sequences, within the card's shared memory and laid out as
the C side lays it out, the tile's items taken in whole turns, the blocks
an SM it states, a persistent grid.  And that the staged layout
(``csrc/axial_attention_eval.cuh``: ``QkvLayout``, three sections a
position forward, four backward) puts each float of q, k, v and dout in a
place of its own and lets a warp's 8 groups read a row with one 16-byte
load a lane on 32 different banks.
"""

import numpy as np
import pytest
import torch

from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk
from wiflow_tpu_torch.ops.kernels.build import SMEM_LIMIT

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
C, G = 64, 8
# (sequences a batch-1 sample gives, length) of each attention axis: the
# flagship's [B, 15, 20, 64] and the MM-Fi model's [B, 17, 10, 64]
AXES = {"flagship-width": (15, 20), "flagship-height": (20, 15),
        "mmfi-width": (17, 10), "mmfi-height": (10, 17)}
SM_SMEM, RESERVED = 233472, 1024
MAX_THREADS, MAX_POSITIONS = 320, 80


def al16(n):
    return -(-n // 16) * 16


def check_core_plan(cp, nseq, length, c, groups, dtype, backward, sms):
    npos = cp.seqs * length
    # whole sequences, at most 80 positions (one sequence where L > 40)
    assert cp.seqs >= 1 and (npos <= MAX_POSITIONS or cp.seqs == 1)
    # every sequence in exactly one tile
    assert cp.tiles == -(-nseq // cp.seqs)
    starts = np.arange(cp.tiles) * cp.seqs
    owner = np.searchsorted(starts, np.arange(nseq), side="right") - 1
    assert np.array_equal(np.bincount(owner, minlength=cp.tiles),
                          np.minimum(cp.seqs, nseq - starts))
    # as csrc/axial_core.cu lays it out: fp32 rows of 3 or 4 sections of
    # C + 8 floats, then (backward) the next tile's rows as they come (4 x
    # C in the storage type), float2 row statistics, the dscale terms of
    # the (sequence, query pair, group) items and G running sums
    pairs = -(-length // 2)
    esize = 2 if dtype == torch.bfloat16 else 4
    if backward:
        want = (npos * (4 * c + 32) * 4, npos * 4 * c * esize,
                al16(npos * groups * 8), al16(cp.seqs * pairs * groups * 4),
                al16(groups * 4))
    else:
        want = (npos * (3 * c + 24) * 4,)
    assert all(x % 16 == 0 for x in want)
    assert cp.layout == want
    assert cp.smem == sum(cp.layout) <= SMEM_LIMIT
    # whole warps, at most 320, taking the items in whole turns of equal
    # size (no turn idles a warp)
    items = cp.seqs * pairs * groups
    turns = -(-items // cp.threads)
    assert cp.threads % 32 == 0 and 32 <= cp.threads <= MAX_THREADS
    assert turns == -(-items // MAX_THREADS)
    assert turns * cp.threads - items < 32 * turns
    # blocks an SM: shared memory, and registers at 96 a thread
    # (__launch_bounds__(320, 2))
    assert cp.blocks_per_sm >= 1
    assert cp.blocks_per_sm * (cp.smem + RESERVED) <= SM_SMEM
    assert cp.blocks_per_sm * cp.threads * 96 <= 65536
    assert cp.grid == min(cp.tiles, cp.blocks_per_sm * sms) >= 1


@pytest.mark.parametrize("sms", (132, 114))
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", (256, 7))
@pytest.mark.parametrize("axis", AXES)
def test_train_attention_plan_at_the_models_axes(axis, batch, dtype, sms):
    per_sample, length = AXES[axis]
    nseq = batch * per_sample
    plan = tk.train_attention_plan(nseq, length, C, G, dtype, sms)
    check_core_plan(plan.forward, nseq, length, C, G, dtype, False, sms)
    check_core_plan(plan.backward, nseq, length, C, G, dtype, True, sms)
    # at the models' widths a tile's items take one turn, and in bf16 (the
    # working type; fp32 is the check type) more than one block shares an
    # SM
    for cp in plan:
        assert cp.seqs * -(-length // 2) * G <= cp.threads
        assert cp.blocks_per_sm >= (2 if dtype == torch.bfloat16 else 1)


@pytest.mark.parametrize("length", range(1, 33))
def test_train_attention_plan_at_every_length(length):
    for nseq, c, groups, dtype, sms in ((7, 64, 8, torch.float32, 132),
                                        (1000, 64, 8, torch.bfloat16, 1),
                                        (33, 32, 4, torch.bfloat16, 114),
                                        (5, 96, 12, torch.float32, 132)):
        plan = tk.train_attention_plan(nseq, length, c, groups, dtype, sms)
        check_core_plan(plan.forward, nseq, length, c, groups, dtype, False,
                        sms)
        check_core_plan(plan.backward, nseq, length, c, groups, dtype, True,
                        sms)


@pytest.mark.parametrize("bad", [
    dict(c=64, groups=4),          # C is not 8 x G
    dict(c=12, groups=1),          # nor here
    dict(length=33),               # L > 32
    dict(length=0),
    dict(nseq=0),
    dict(dtype=torch.float16),
])
def test_train_attention_plan_refuses_what_the_kernels_cannot_take(bad):
    args = dict(nseq=7, length=20, c=64, groups=8, dtype=torch.bfloat16)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        tk.train_attention_plan(*args.values())


# -- the staged layout --------------------------------------------------------

def qkv_at(c, section, g, cc):
    """``QkvLayout::at``: the float of channel cc of group g in a section;
    a section is C + 8 floats: channels 0-3 of every group (group g at
    4 g), 4 floats of padding, channels 4-7 of every group, 4 more."""
    return section * (c + 8) + (cc >> 2) * (c // 2 + 4) + 4 * g + (cc & 3)


@pytest.mark.parametrize("sections", (3, 4), ids=("forward", "backward"))
@pytest.mark.parametrize("c", (64, 32, 8))
def test_staged_layout_is_a_bijection_onto_the_data_floats(c, sections):
    row = sections * (c + 8)
    assert row == {3: 3 * c + 24, 4: 4 * c + 32}[sections]
    places = [qkv_at(c, s, g, cc) for s in range(sections)
              for g in range(c // 8) for cc in range(8)]
    assert len(set(places)) == len(places) == sections * c
    # the floats that hold data: each section's two halves of C / 2
    data = {s * (c + 8) + h * (c // 2 + 4) + x for s in range(sections)
            for h in range(2) for x in range(c // 2)}
    assert set(places) == data
    assert max(places) < row


@pytest.mark.parametrize("sections", (3, 4), ids=("forward", "backward"))
def test_a_warps_groups_read_a_row_in_one_wavefront(sections):
    """Lanes 8 p .. 8 p + 7 of a warp (one item's 8 groups: consecutive
    threads take the groups of one position) each load 16 bytes, channels
    0-3 or 4-7 of their group, of one staged row: 32 words on 32 banks,
    which shared memory serves in one 128-byte wavefront.  Each load is
    16-byte aligned, rows and sections included."""
    row_words = sections * (C + 8)
    assert row_words * 4 % 16 == 0
    for pos in (0, 1, 7):
        for s in range(sections):
            for half in (0, 4):
                words = [pos * row_words + qkv_at(C, s, g, half) + k
                         for g in range(G) for k in range(4)]
                assert all(w % 4 == 0 for w in words[::4])
                banks = {w % 32 for w in words}
                assert len(banks) == 32
                assert max(words) - min(words) == 31


# -- the wrappers' stride check -----------------------------------------------

def test_thirds_of_a_projection_are_read_in_place():
    qkv = torch.zeros((7, 20, 3 * C), dtype=torch.bfloat16)
    q, k, v = qkv.split(C, dim=-1)
    got, ld = tk._rows((q, k, v), ("q", "k", "v"))
    assert ld == 3 * C
    assert [t.data_ptr() for t in got] == [t.data_ptr() for t in (q, k, v)]


def test_rows_the_kernels_cannot_load_are_copied_aligned():
    """A position stride that is not whole 16-byte words, or a tensor that
    does not start on one, gets contiguous aligned copies (``ld = C``)."""
    odd = torch.zeros((7, 20, 3 * C + 1), dtype=torch.float32)
    thirds = [odd[..., 1 + i * C:1 + (i + 1) * C] for i in range(3)]
    got, ld = tk._rows(thirds, ("q", "k", "v"))
    assert ld == C
    for t, src in zip(got, thirds):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert torch.equal(t, src)
    flat = torch.arange(7 * 20 * C + 1, dtype=torch.float32)
    shifted = flat[1:].reshape(7, 20, C)           # contiguous, 4 bytes off
    got, ld = tk._rows([shifted] * 3, ("q", "k", "v"))
    assert ld == C and all(t.data_ptr() % 16 == 0 for t in got)
    assert torch.equal(got[0], shifted)
