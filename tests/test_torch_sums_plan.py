"""The launch plan of the logits-sums kernels and the closed form they
compute, held on the CPU.

``ops/kernels/axial_attention_train.py::sums_plan`` is a pure function of
the shapes, the dtype and the SM count; the kernels
(``csrc/logits_sums.cu``) run on the card only.  What can be held here is
that every plan is one the kernels accept: each (sequence, group) taken by
one q lane and one k lane in each range of positions, the ranges covering
a sequence's positions once, whole sequences a tile of 256 lanes, the
lanes of a (sequence, group) within one warp, and persistent grids; and
that the forward's workspace is one a stream and is not made while a CUDA
graph is being captured.

And that the Gram form the kernels compute gives what the JAX package's
``logits_sums`` and its VJP give (the Pallas kernels in interpret mode, as
``tests/test_torch_attention_train.py`` runs them), held by a torch mirror
of the kernels at 8 channels a group: per (sequence, group) the sums and
Grams of q and k, the forward's fixed order of reduction (each block's
tiles in turn, then its sequences, into fp32 partials, then a float64 sum
over the blocks), and ``dq_i = d1 Ks + 2 d2 Gk q_i``, ``dk_j = d1 Qs + 2 d2
Gq k_j``.  The mirror's sums are also held to float64 brute force.
Tolerance: 2e-4 of the reference's largest entry, the serving tests'
(``TOL``); the gradients too (the Gram form sums L terms where the
reference sums L x L).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.ops.pallas import axial_attention_train as jax_train
from wiflow_tpu.ops.pallas.axial_attention import scramble_perm

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.ops.kernels import axial_attention_train as tk

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
C, G, GC = 64, 8, 8
# (sequences a batch-1 sample gives, length) of each attention axis: the
# flagship's [B, 15, 20, 64] and the MM-Fi model's [B, 17, 10, 64]
AXES = {"flagship-width": (15, 20), "flagship-height": (20, 15),
        "mmfi-width": (17, 10), "mmfi-height": (10, 17)}
THREADS = 256
BLOCKS_PER_SM = (3, 2)     # forward, backward: the kernels' launch bounds


def ranges(length, parts):
    """Each range's (first position, count), as ``csrc/logits_sums.cu``'s
    ``Lane`` cuts a sequence."""
    span = -(-length // parts)
    out = []
    for part in range(parts):
        i0 = min(length, part * span)
        out.append((i0, min(length, i0 + span) - i0))
    return out


def lanes_of(plan):
    """(qk, part, group slot, sequence slot) of each thread of a block."""
    e = np.arange(plan.threads)
    item = e // (2 * plan.parts)
    return (e % 2, e // 2 % plan.parts, item % plan.gslots,
            item // plan.gslots)


def check_plan(p, nseq, length, c, groups, sms):
    # q's and k's lane of each range, the groups padded to a power of two
    assert p.gslots == 1 << (groups - 1).bit_length() and p.gslots >= groups
    assert p.parts in (1, 2, 4) and p.parts <= length
    assert p.lanes == 2 * p.parts
    assert p.threads == THREADS == p.seqs * p.gslots * p.lanes
    assert p.threads % 32 == 0 and 32 % p.lanes == 0
    # the fewest ranges a lane (1, 2 or 4, at most L) at which the tiles
    # give at least half the SMs a block, else the most
    allowed = [parts for parts in (1, 2, 4) if parts <= length and
               2 * parts * p.gslots <= THREADS]
    fewest = next((parts for parts in allowed if
                   2 * -(-nseq // (THREADS // (2 * parts * p.gslots))) >= sms),
                  allowed[-1])
    assert p.parts == fewest
    # the ranges cover a sequence's positions once
    covered = np.zeros(length, int)
    for i0, n in ranges(length, p.parts):
        covered[i0:i0 + n] += 1
    assert (covered == 1).all()
    # every (sequence, group) once for q and once for k in each range
    assert p.tiles == -(-nseq // p.seqs)
    qk, part, g, slot = lanes_of(p)
    seen = np.zeros((p.tiles * p.seqs, p.gslots, 2, p.parts), int)
    for tile in range(p.tiles):
        np.add.at(seen, (tile * p.seqs + slot, g, qk, part), 1)
    assert (seen[:nseq, :groups] == 1).all()
    # the lanes of a (sequence, group) are neighbours in one warp
    e = np.arange(p.threads)
    assert (e // p.lanes * p.lanes // 32 == e // 32).all()
    # persistent grids walking the tiles, one workspace row a forward block
    assert p.grid == min(p.tiles, BLOCKS_PER_SM[0] * sms) >= 1
    assert p.backward_grid == min(p.tiles, BLOCKS_PER_SM[1] * sms) >= 1


@pytest.mark.parametrize("sms", (1, 66, 132))
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", (256, 64, 7))
@pytest.mark.parametrize("axis", AXES)
def test_sums_plan_at_the_models_axes(axis, batch, dtype, sms):
    per_sample, length = AXES[axis]
    nseq = batch * per_sample
    p = tk.sums_plan(nseq, length, C, G, dtype, sms)
    check_plan(p, nseq, length, C, G, sms)
    if sms == 132:
        # the train step's launches at batch 256; at batch 64 two ranges
        # where one leaves more than half the SMs idle; at 7 sequences four
        want = {256: 1, 7: 4}.get(batch) or {
            "flagship-width": 2, "flagship-height": 1, "mmfi-width": 1,
            "mmfi-height": 2}[axis]
        assert p.parts == want


@pytest.mark.parametrize("sms", (1, 66, 132))
@pytest.mark.parametrize("length", range(1, 33))
def test_sums_plan_at_every_length(length, sms):
    for nseq, groups in ((7, G), (3840, G), (5, 3), (9, 1), (2, 16)):
        check_plan(tk.sums_plan(nseq, length, 8 * groups, groups,
                                torch.bfloat16, sms),
                   nseq, length, 8 * groups, groups, sms)


@pytest.mark.parametrize("bad", [
    dict(c=60), dict(c=72), dict(groups=7),      # C != 8 G
    dict(c=8 * 129, groups=129),                 # more groups than lanes
    dict(length=33), dict(length=0), dict(nseq=0),
    dict(dtype=torch.float16),
])
def test_sums_plan_refuses_what_the_kernels_cannot_take(bad):
    args = dict(nseq=7, length=20, c=C, groups=G, dtype=torch.float32)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        tk.sums_plan(**args)


def test_sums_plan_takes_the_ranges_it_is_allowed():
    # the plan at a given number of ranges, as logits_sums_sweep.py times it
    p = tk.sums_plan_at(3840, G, 4, 132)
    assert p == tk.SumsPlan(parts=4, lanes=8, gslots=8, seqs=4, threads=256,
                            tiles=960, grid=396, backward_grid=264)
    for parts in (1, 2, 4):
        q = tk.sums_plan_at(960, G, parts, 132)
        assert (q.parts, q.lanes, q.seqs * q.lanes * q.gslots) == (
            parts, 2 * parts, THREADS)
    planned = tk.sums_plan(3840, 20, C, G, torch.bfloat16)
    assert planned == tk.sums_plan_at(3840, G, planned.parts, 132)
    assert planned.parts == 1
    assert tk.sums_plan(7, 3, C, G, torch.bfloat16).parts == 2


def test_sums_workspace_is_one_a_stream(monkeypatch):
    # the forward's partials and counter: one set a (device, stream, plan),
    # never made while a CUDA graph is being captured
    monkeypatch.setattr(tk, "_WORKSPACE", {})
    capturing = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: bool(capturing))
    dev = torch.device("cpu")
    a = tk._workspace(dev, 1, 240, 16)
    assert tk._workspace(dev, 1, 240, 16) is a
    assert a[0].shape == (240, 16) and a[1].tolist() == [0]
    b = tk._workspace(dev, 2, 240, 16)
    assert b[0].data_ptr() != a[0].data_ptr()
    capturing.append(True)
    assert tk._workspace(dev, 2, 240, 16) is b
    with pytest.raises(RuntimeError, match="capture"):
        tk._workspace(dev, 3, 240, 16)


# ---------------------------------------------------------------------------
# the closed form, mirrored
# ---------------------------------------------------------------------------

def moments(t, groups):
    """Per (sequence, group): the sum over positions ``[N, G, 8]`` and the
    Gram ``[N, G, 8, 8]``, fp32."""
    n, length, c = t.shape
    x = t.float().reshape(n, length, groups, c // groups)
    return x.sum(1), torch.einsum("nigc,nigd->ngcd", x, x)


def mirror_forward(q, k, groups, plan):
    """``[2, G]``: per (sequence, group) ``Qs . Ks`` and ``<Gq, Gk>`` in fp32;
    each block's tiles in turn and then its sequences into an fp32 partial
    ``[grid, 2, G]``; the blocks summed in float64."""
    qs, gq = moments(q, groups)
    ks, gk = moments(k, groups)
    per_seq = torch.stack([(qs * ks).sum(-1), (gq * gk).sum((-1, -2))], 1)
    pad = plan.tiles * plan.seqs - per_seq.shape[0]
    tiles = torch.cat([per_seq, per_seq.new_zeros((pad, 2, groups))])
    tiles = tiles.reshape(plan.tiles, plan.seqs, 2, groups)
    lanes = tiles.new_zeros((plan.grid, plan.seqs, 2, groups))
    for tile in range(plan.tiles):            # a lane's tiles, in turn
        lanes[tile % plan.grid] += tiles[tile]
    partial = lanes.sum(1)                     # a block's sequences
    return partial.double().sum(0).float()


def mirror_backward(q, k, dsums):
    """``(dq, dk)``: ``d1 Ks + 2 d2 Gk q_i`` and ``d1 Qs + 2 d2 Gq k_j``."""
    n, length, c = q.shape
    groups = dsums.shape[1]
    qs, gq = moments(q, groups)
    ks, gk = moments(k, groups)
    d1 = dsums[0].float()[None, :, None]
    d2 = 2 * dsums[1].float()[None, :, None, None]
    x = (q.float().reshape(n, length, groups, -1),
         k.float().reshape(n, length, groups, -1))
    dq = d1 * ks[:, None] + torch.einsum("ngcd,nigd->nigc", d2 * gk, x[0])
    dk = d1 * qs[:, None] + torch.einsum("ngcd,nigd->nigc", d2 * gq, x[1])
    return dq.reshape(n, length, c), dk.reshape(n, length, c)


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _to_kernel_layout(t, c, groups):
    """``[N, L, C]`` -> the Pallas kernels' scrambled ``[L, C, N]``."""
    perm = scramble_perm(c, groups)
    return jnp.asarray(np.ascontiguousarray(t[:, :, perm].transpose(1, 2, 0)))


def _from_kernel_layout(t, c, groups):
    inv = np.argsort(scramble_perm(c, groups))
    return np.asarray(t).transpose(2, 0, 1)[:, :, inv]


@pytest.mark.parametrize("length,n", [(20, 199), (15, 199), (10, 199),
                                      (17, 199)])
def test_mirror_of_the_kernels_matches_pallas(length, n):
    groups = 2                       # 8 channels a group, as the kernels
    c = GC * groups
    rng = np.random.default_rng(200 + length)
    q, k = (rng.standard_normal((n, length, c)).astype(np.float32)
            for _ in range(2))
    dsums = rng.standard_normal((2, groups)).astype(np.float32)

    ref, vjp = jax.vjp(
        lambda a, b: jax_train.logits_sums(a, b, groups, 8, True),
        _to_kernel_layout(q, c, groups), _to_kernel_layout(k, c, groups))
    rdq, rdk = vjp(jnp.asarray(dsums))

    tq, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    # one SM: 3 blocks walk 4 tiles
    plan = tk.sums_plan(n, length, c, groups, torch.float32, 1)
    assert plan.tiles > plan.grid > 1
    sums = mirror_forward(tq, tk_, groups, plan)
    _close(sums, ref, TOL, "sums vs Pallas")
    lg = np.einsum("nigc,njgc->gnij",
                   q.reshape(n, length, groups, GC).astype(np.float64),
                   k.reshape(n, length, groups, GC).astype(np.float64))
    brute = np.stack([lg.sum((1, 2, 3)), (lg ** 2).sum((1, 2, 3))])
    for row, what in enumerate(("sum", "sum of squares")):
        _close(sums[row], brute[row], TOL, f"{what} vs float64")
    dq, dk = mirror_backward(tq, tk_, torch.from_numpy(dsums))
    _close(dq, _from_kernel_layout(rdq, c, groups), TOL, "dq vs Pallas")
    _close(dk, _from_kernel_layout(rdk, c, groups), TOL, "dk vs Pallas")
    # and the port's plain version (what a CPU tensor runs) agrees
    _close(sums, tk.logits_sums_plain(tq, tk_, groups), TOL, "sums vs plain")
