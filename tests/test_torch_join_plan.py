"""The launch plan of the join kernels and the sums their backward forms,
held on the CPU.

``ops/kernels/stage_fused.py::join_plan`` is a pure function of the rows,
the channels, the dtype and the SM count; the kernels
(``csrc/join_fused.cu``) run on the card only.  What can be held here is
that every plan is one the kernels accept: a chunk of ``vec`` channels the
widest aligned load that divides C, the threads of a block and the slices
covering every channel of a row once, the tiles of the persistent grid
covering every row once (the last tile part-filled), the backward's finish
small enough for one block a slice, and the backward's workspace sized
for the plan, one a stream, never made while a CUDA graph is captured.

And that the backward's decomposition gives what the JAX package's
``join`` VJP gives (its Pallas kernels in interpret mode, as
``tests/test_torch_stage_fused.py`` runs them) and what autograd of
``join_plain`` gives, held by a torch mirror of the kernel: each thread's
fp32 sums over its rows in turn, the block's row lanes in the kernel's
fixed order into one fp32 partial a channel and block, the float64 finish
over the blocks in its fixed order, and the chain rule ``g_m = -a B,
g_a = A - m B, g_b = B``.  Tolerance: 2e-4 of the reference's largest
entry, the serving tests' (``TOL``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiflow_tpu.ops.pallas.stage_fused import join as jax_join

from tests.test_torch_harness import TOL
from wiflow_tpu_torch.core.config import ModelConfig
from wiflow_tpu_torch.ops.kernels import stage_fused as sk

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
THREADS = 256          # a block's most threads
FINISH = 2048          # most float4 partials the last block of a slice sums
KEEP = 0.7


def tiles_rows(npos, plan, grid):
    """How often each row is taken by a persistent grid: block x walks
    tiles x, x + grid, ... of ``rows`` rows each, lane l taking row
    ``tile * rows + l``."""
    tiles = -(-npos // plan.rows)
    seen = np.zeros(tiles * plan.rows, int)
    for x in range(grid):
        for tile in range(x, tiles, grid):
            seen[tile * plan.rows + np.arange(plan.rows)] += 1
    return seen[:npos], seen[npos:]


def check_plan(p, npos, c, dtype, backward, sms=132):
    esize = 2 if dtype == torch.bfloat16 else 4
    # the widest of 8/4/2/1 channels, at most 16 bytes (and at most 4 in
    # the backward), that divides C
    most = min(16 // esize, 4 if backward else 8)
    assert c % p.vec == 0 and p.vec <= most
    assert all(c % w or w > most for w in (8, 4, 2, 1) if w > p.vec)
    assert p.groups == c // p.vec
    # every chunk starts at a multiple of its width: one aligned load
    for row in (0, 1, npos - 1):
        assert ((row * c + p.vec * np.arange(p.groups)) % p.vec == 0).all()
    # a block: rows x cols threads, at most 256, and at most 256 channels
    assert p.threads == p.rows * p.cols <= THREADS
    assert p.rows == THREADS // p.cols and p.cols * p.vec <= THREADS
    # the slices' threads tile the channels exactly once
    assert p.slices == -(-p.groups // p.cols)
    seen = np.zeros(p.slices * p.cols * p.vec, int)
    for y in range(p.slices):
        for slot in range(p.cols):
            ch = (y * p.cols + slot) * p.vec
            seen[ch:ch + p.vec] += 1
    assert (seen == 1).all() and len(seen) - c < p.cols * p.vec
    # a ring of 2 rows a thread; a persistent grid, 3 blocks an SM across
    # the slices (2 in a forward of 16-byte chunks), covers every row
    # once, past the last row only the last tile's idle lanes
    assert p.stages == 2
    tiles = -(-npos // p.rows)
    blocks = 2 if p.vec * esize == 16 and not backward else 3
    assert sk.join_blocks_per_sm(p.vec, esize, backward) == blocks
    assert p.grid == min(tiles, -(-blocks * sms // p.slices)) >= 1
    inside, past = tiles_rows(npos, p, p.grid)
    assert (inside == 1).all() and (past <= 1).all()
    assert len(past) < p.rows
    fewer = [sk.join_plan_at(npos, c, dtype, backward, s, sms)
             for s in range(1, p.slices)
             if -(-p.groups // s) * p.vec <= THREADS]
    fewer = [q for q in fewer if q.slices < p.slices]
    if not backward:
        # the forward: the fewest slices of at most 256 channels
        assert not fewer
        return p
    # the backward's finish: at most FINISH float4 partials a slice, unless
    # a narrower slice would be less than a 32-byte sector of a row; and no
    # fewer slices would have done
    narrower = -(-p.groups // (p.slices + 1))
    assert (p.grid * p.cols * p.vec <= FINISH
            or narrower * p.vec * esize < 32 or narrower == p.cols)
    assert all(q.grid * q.cols * q.vec > FINISH for q in fewer)
    return p


def step_joins(batch):
    _, joins = sk.step_launches(ModelConfig(), batch)
    return joins


DIRECTIONS = {"fwd": False, "bwd": True}


@pytest.mark.parametrize("backward", DIRECTIONS.values(), ids=DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("batch", (256, 64, 7))
@pytest.mark.parametrize("index", range(9))
def test_join_plan_at_the_step_joins(index, batch, dtype, backward):
    joins = step_joins(batch)
    assert len(joins) == 9
    j = joins[index]
    npos = math.prod(j["lead"])
    p = check_plan(sk.join_plan(npos, j["c"], dtype, backward), npos,
                   j["c"], dtype, backward)
    if batch == 256 and dtype == torch.bfloat16:
        # the TCN's rows of 540 and 340 channels take 4-channel chunks,
        # the rest 8 forward, 4 backward; a forward conv join of 8
        # channels is a row a thread, a forward row of up to 256 channels
        # one slice
        assert p.vec == (4 if j["c"] in (540, 340) or backward else 8)
        if not backward:
            assert p.slices == -(-j["c"] // 256)
            if j["c"] == 8:
                assert (p.cols, p.rows) == (1, 256)


@pytest.mark.parametrize("backward", DIRECTIONS.values(), ids=DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("npos", (2560, 70, 1))
@pytest.mark.parametrize("c", (342, 306, 288, 17, 3, 1))
def test_join_plan_at_odd_widths(c, npos, dtype, backward):
    p = check_plan(sk.join_plan(npos, c, dtype, backward), npos, c, dtype,
                   backward)
    wide = 8 if dtype == torch.bfloat16 and not backward else 4
    want = {342: 2, 306: 2, 288: wide, 17: 1, 3: 1, 1: 1}[c]
    assert p.vec == want


@pytest.mark.parametrize("sms", (1, 66))
def test_join_plan_at_fewer_sms(sms):
    for npos, c in ((1228800, 8), (5120, 540), (5120, 240), (76800, 64)):
        for backward in (False, True):
            check_plan(sk.join_plan(npos, c, torch.bfloat16, backward, sms),
                       npos, c, torch.bfloat16, backward, sms)


@pytest.mark.parametrize("bad", [
    dict(npos=0), dict(c=0), dict(npos=2 ** 20, c=2 ** 11),
    dict(dtype=torch.float16),
])
def test_join_plan_refuses_what_the_kernels_cannot_take(bad):
    args = dict(npos=7, c=8, dtype=torch.float32, backward=True)
    args.update(bad)
    with pytest.raises((ValueError, TypeError)):
        sk.join_plan(**args)


def test_join_plan_at_a_given_slicing():
    p = sk.join_plan_at(5120, 540, torch.bfloat16, True, 11)
    assert p == sk.JoinPlan(vec=4, groups=135, cols=13, slices=11, rows=19,
                            threads=247, stages=2, grid=36)
    assert p == sk.join_plan(5120, 540, torch.bfloat16, True)
    assert p.ints() == (4, 13, 19, 11, 2, 36)
    q = sk.join_plan(5120, 540, torch.bfloat16, False)
    assert (q.cols, q.slices, q.rows, q.grid) == (45, 3, 5, 132)
    with pytest.raises(ValueError):
        sk.join_plan_at(5120, 540, torch.bfloat16, True, 1)   # 540 > 256


def test_join_workspace_is_one_a_stream(monkeypatch):
    # the backward's partials and counters: one set a (device, stream,
    # plan), sized [grid, C, 4] and [slices], never made while a CUDA
    # graph is being captured
    monkeypatch.setattr(sk, "_JOIN_WORKSPACE", {})
    capturing = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: bool(capturing))
    dev = torch.device("cpu")
    p = sk.join_plan(5120, 540, torch.bfloat16, True)
    a = sk._join_workspace(dev, 1, p, 540)
    assert sk._join_workspace(dev, 1, p, 540) is a
    assert a[0].shape == (p.grid, 540, 4) and a[0].dtype == torch.float32
    assert a[1].tolist() == [0] * p.slices and a[1].dtype == torch.int32
    q = sk.join_plan(76800, 64, torch.bfloat16, True)
    b = sk._join_workspace(dev, 1, q, 64)
    assert b[0].shape == (q.grid, 64, 4) and b[1].shape == (q.slices,)
    c = sk._join_workspace(dev, 2, p, 540)
    assert c[0].data_ptr() != a[0].data_ptr()
    capturing.append(True)
    assert sk._join_workspace(dev, 2, p, 540) is c
    with pytest.raises(RuntimeError, match="capture"):
        sk._join_workspace(dev, 3, p, 540)


# ---------------------------------------------------------------------------
# the backward's decomposition, mirrored
# ---------------------------------------------------------------------------

def element_grads(h, res, go, vh, vr, mask, act_h):
    """Per element, in fp32 as the kernel: the cotangents gu of
    ``u_h = norm_h(h)`` and gv of ``u_r`` (the output's pre-activation),
    ``gh``, ``gres``, and the sums' terms ``[gu h, gu, gv res, gv]``."""
    uh = (h - vh[0]) * vh[1] + vh[2]
    sig_h = torch.sigmoid(uh)
    v = uh * sig_h if act_h else uh
    if mask is not None:
        v = torch.where(mask, v / KEEP, torch.zeros(()))
    r = res if vr is None else (res - vr[0]) * vr[1] + vr[2]
    s = v + r
    sig = torch.sigmoid(s)
    gv = go * sig * (1 + s * (1 - sig))
    gu = gv if mask is None else torch.where(mask, gv / KEEP, torch.zeros(()))
    if act_h:
        gu = gu * sig_h * (1 + uh * (1 - sig_h))
    gres = gv if vr is None else gv * vr[1]
    terms = torch.stack([gu * h, gu, gv * res, gv], -1)
    return gu * vh[1], gres, terms


def mirror_backward(terms, plan, vh, vr):
    """``gvec [2, 3, C]`` from the terms ``[npos, C, 4]`` summed as the
    backward kernel sums them."""
    npos, c, _ = terms.shape
    n = plan.cols * plan.vec
    tiles, grid = -(-npos // plan.rows), plan.grid
    pad = torch.zeros((tiles * plan.rows, plan.slices * n, 4))
    pad[:npos, :c] = terms
    # [tile, lane, slice, channel of the slice, sum]
    t = pad.reshape(tiles, plan.rows, plan.slices, n, 4)
    # each thread (block, lane, slice, chunk): its tiles in turn, in fp32
    acc = torch.zeros((grid, plan.rows, plan.slices, n, 4))
    for k in range(-(-tiles // grid)):
        tile = torch.arange(grid) + k * grid
        live = tile < tiles
        acc[live] = acc[live] + t[tile[live]]
    # the block's lanes: `parts` strided ranges of lanes, then the parts
    parts = 1
    while 2 * parts * n <= plan.threads:
        parts *= 2
    red = torch.zeros((grid, parts, plan.slices, n, 4))
    for lane in range(plan.rows):
        red[:, lane % parts] = red[:, lane % parts] + acc[:, lane]
    partial = red[:, 0]
    for part in range(1, parts):
        partial = partial + red[:, part]
    # the last block of a slice: float64, `parts` strided ranges of the
    # blocks, then the parts in order
    fin = torch.zeros((parts, plan.slices, n, 4), dtype=torch.float64)
    for x in range(grid):
        fin[x % parts] = fin[x % parts] + partial[x].double()
    tot = fin[0]
    for part in range(1, parts):
        tot = tot + fin[part]
    tot = tot.reshape(plan.slices * n, 4)[:c]
    gvec = torch.zeros((2, 3, c), dtype=torch.float64)
    for branch, vecs in enumerate((vh, vr)):
        if vecs is None:
            continue
        m, a = vecs[0].double(), vecs[1].double()
        ta, tb = tot[:, 2 * branch], tot[:, 2 * branch + 1]
        gvec[branch] = torch.stack([-a * tb, ta - m * tb, tb])
    return gvec.float()


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# (C, slices, SMs): several blocks, a block walking several tiles, the
# last tile part-filled, rows cut in slices (one with an idle chunk)
MIRROR_SHAPES = {"c24": (24, 1, 1), "c24-2slices": (24, 2, 2),
                 "c20-2slices": (20, 2, 2), "c6": (6, 3, 1)}


@pytest.mark.parametrize("shape", MIRROR_SHAPES)
@pytest.mark.parametrize("mask", ["element", None, "sample"])
@pytest.mark.parametrize("res_norm", [True, False])
def test_mirror_of_the_backward_matches_jax_and_plain(res_norm, mask, shape):
    c, slices, sms = MIRROR_SHAPES[shape]
    act_h = mask != "sample"
    ng, nl = 3, 160                    # 3 samples of 160 positions
    npos = ng * nl
    rng = np.random.default_rng(300 + c + 7 * slices)
    hb, rb = (rng.standard_normal((ng, c, nl)).astype(np.float32)
              for _ in range(2))
    gb = (0.1 * rng.standard_normal((ng, c, nl))).astype(np.float32)
    vh = [rng.standard_normal(c).astype(np.float32) for _ in range(3)]
    vh[1] = (0.5 + rng.random(c)).astype(np.float32)
    vr = ([rng.standard_normal(c).astype(np.float32) for _ in range(3)]
          if res_norm else [None] * 3)
    if mask == "element":
        bits = rng.random((ng, c, nl)) < KEEP
    elif mask == "sample":
        bits = np.repeat(rng.random((ng, c, 1)) < KEEP, nl, axis=2)
    else:
        bits = None

    # the JAX package's join, its Pallas kernels in interpret mode
    jmask = None if bits is None else jnp.asarray(bits)
    jargs = [None if a is None else jnp.asarray(a) for a in (hb, *vh, rb, *vr)]
    argn = tuple(i for i, a in enumerate(jargs) if a is not None)

    def jloss(*args):
        full = list(jargs)
        for i, a in zip(argn, args):
            full[i] = a
        return jnp.sum(jax_join(*full[:4], jmask, *full[4:], keep=KEEP,
                                interpret=True, act_h=act_h) * gb)

    jgrads = dict(zip(argn, jax.grad(jloss, argnums=tuple(range(len(argn))))(
        *[jargs[i] for i in argn])))

    # rows [ng * nl, C], as the port takes them
    def rows(x):
        return torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 2, 1)).reshape(npos, c))

    h, res, go = rows(hb), rows(rb), rows(gb)
    th = [torch.from_numpy(v) for v in vh]
    tr = None if not res_norm else [torch.from_numpy(v) for v in vr]
    tmask = None if bits is None else rows(bits)
    plan = sk.join_plan_at(npos, c, torch.float32, True, slices, sms)
    tiles = -(-npos // plan.rows)
    assert plan.slices == slices and npos % plan.rows
    assert (plan.grid > 1 and tiles > plan.grid) or shape == "c6"
    gh, gres, terms = element_grads(h, res, go, th, tr, tmask, act_h)
    gvec = mirror_backward(terms, plan, th, tr)

    def blocks(x):
        return x.reshape(ng, nl, c).permute(0, 2, 1).numpy()

    _close(blocks(gh), jgrads[0], "gh vs Pallas")
    _close(blocks(gres), jgrads[4], "gres vs Pallas")
    names = ("g_m", "g_a", "g_b")
    for k in range(3):
        _close(gvec[0, k], jgrads[1 + k], f"{names[k]}_h vs Pallas")
        if res_norm:
            _close(gvec[1, k], jgrads[5 + k], f"{names[k]}_r vs Pallas")

    # autograd of the plain version (what a CPU tensor runs); a per-sample
    # mask as one bit per (sample, channel)
    leaves = [t.clone().requires_grad_(True)
              for t in (h, *th, res, *(tr or ()))]
    pmask = tmask
    if mask == "sample":
        pmask = torch.from_numpy(bits[:, :, 0])
        lead = (ng, nl)
        leaves[0] = leaves[0].detach().reshape(*lead, c).requires_grad_(True)
        leaves[4] = leaves[4].detach().reshape(*lead, c).requires_grad_(True)
    vr_leaves = leaves[5:] if res_norm else [None] * 3
    out = sk.join_plain(*leaves[:4], pmask, leaves[4], *vr_leaves, keep=KEEP,
                        act_h=act_h)
    out.backward(go.reshape(out.shape))
    _close(gh, leaves[0].grad.reshape(npos, c), "gh vs plain")
    _close(gres, leaves[4].grad.reshape(npos, c), "gres vs plain")
    for k in range(3):
        _close(gvec[0, k], leaves[1 + k].grad, f"{names[k]}_h vs plain")
        if res_norm:
            _close(gvec[1, k], leaves[5 + k].grad, f"{names[k]}_r vs plain")
