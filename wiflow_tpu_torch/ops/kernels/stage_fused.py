"""Train-mode stage and join: CUDA kernels and their plain versions.

Counterpart of ``wiflow_tpu/ops/pallas/stage_fused.py``.  On channel-last
activations (``[B, T, C]`` in the TCN, ``[B, H, W, C]`` in the conv stack),
with ``norm(x) = (x - m) * a + b`` per channel (the BatchNorm apply, its
vectors from ``ops/norm.py::bn_vectors_from_sums``):

    stage(x, m, a, b, mask, weight, bias, kind=...) -> (out, sums)
        act  = dropout(silu(norm(x)))        (prologue and mask optional)
        out  = conv(act, weight) + bias      (one of five geometries)
        sums = [sum, sum of squares] of out over all but its channel
               axis, fp32 ``[2, C_out]``: the next BatchNorm's moments
    join(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r, act_h=...) -> out
        out  = silu(dropout(silu(norm_h(h)) or norm_h(h))
                    + (norm_r(res) or res))

The geometries (``kind``), all over the next-to-last axis W of ``x``:

    causal3   grouped causal k=3 conv with dilation ``dil``, zero before 0
    identity  pointwise conv
    sym3      k=3 conv, pad 1, stride 1
    chunk3    k=3 conv, pad 1, stride 2
    chunk1    pointwise conv, stride 2

``weight`` is in torch's own layout (``nn.Conv1d`` ``[Co, Ci/G, K]``,
``nn.Conv2d`` ``[Co, Ci, 1, K]``), so the gradient comes back in the
parameter's layout; the groups follow from its shape.  ``m, a, b`` are
fp32 ``[C]`` and are rounded to ``x.dtype`` where they are applied.
``mask`` is a bool keep-mask, either of ``x``'s shape or one bit per
(sample, channel) (``[B, C]`` or ``[B, 1, 1, C]``), never expanded.

Both are ``torch.autograd.Function``s whose forward and backward are
kernels (``csrc/stage_fused.cu``, ``csrc/join_fused.cu``); a backward
recomputes the prologue from the saved input.  A CUDA tensor goes through
the kernels (or raises); a CPU tensor through the plain versions, stock
torch ops that autograd differentiates.  The TPU kernels' ``[ng, C,
T*Nb]`` lane blocks, block-diagonal grouped taps and space-to-depth
chunks are not carried over.

How a stage's three kernels are launched (tensor-core GEMM, streamed
weights, direct pass or fp32 FMAs; tiles, padding, grid, shared memory) is
decided by :func:`stage_plan`, a pure function of the geometry and the
dtype that the CPU tests hold; the C side checks every plan it is given.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from wiflow_tpu_torch.core.config import tcn_conv_groups
from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TPU = "wiflow_tpu/ops/pallas/stage_fused.py"
STAGE_FORWARD = CudaKernel(
    "stage_fused", "stage_forward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _P] + [_I] * 25 + [_P],
    replaces=f"{_TPU}:516")
STAGE_BACKWARD = CudaKernel(
    "stage_fused", "stage_backward",
    [_I, _P, _P, _P, _P, _P, _I, _F] + [_P] * 11 + [_I] + [_I] * 40 + [_P],
    replaces=f"{_TPU}:596")
JOIN_FORWARD = CudaKernel(
    "join_fused", "join_forward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _I, _P] + [_I] * 8
    + [_P],
    replaces=f"{_TPU}:839")
JOIN_BACKWARD = CudaKernel(
    "join_fused", "join_backward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _I] + [_P] * 6
    + [_I] * 8 + [_P],
    replaces=f"{_TPU}:879")
KERNELS = (STAGE_FORWARD, STAGE_BACKWARD, JOIN_FORWARD, JOIN_BACKWARD)

# (taps, stride, pad) of each geometry; the tap j of output position wo
# reads input position wo * stride + (j - pad) * dil
_KINDS = {"causal3": (3, 1, 2), "identity": (1, 1, 0), "sym3": (3, 1, 1),
          "chunk3": (3, 2, 1), "chunk1": (1, 2, 0)}
_SMS = 132         # streaming multiprocessors of the card
_THREADS = 256     # threads of every block, as 8 warps


class _Geom(NamedTuple):
    rows: int
    win: int
    wout: int
    ci: int
    co: int
    groups: int
    ktaps: int
    stride: int
    dil: int
    pad: int


def _geometry(x: torch.Tensor, weight: torch.Tensor, kind: str,
              dil: int) -> _Geom:
    if kind not in _KINDS:
        raise ValueError(f"stage kind {kind!r}: one of {sorted(_KINDS)}")
    ktaps, stride, pad = _KINDS[kind]
    if kind != "causal3":
        dil = 1
    if x.ndim < 2:
        raise ValueError(f"stage takes [..., W, C], got {tuple(x.shape)}")
    win, ci = x.shape[-2], x.shape[-1]
    co, cig = weight.shape[0], weight.shape[1]
    if (weight.numel() != co * cig * ktaps or weight.shape[-1] != ktaps
            or cig < 1 or ci % cig or co % (ci // cig)):
        raise ValueError(f"weight {tuple(weight.shape)} does not fit a "
                         f"{kind} conv of {ci} channels")
    rows = x.numel() // (win * ci)
    return _Geom(rows, win, (win - 1) // stride + 1, ci, co, ci // cig,
                 ktaps, stride, dil, pad)


def _mask_div(mask: Optional[torch.Tensor], x: torch.Tensor) -> int:
    """Positions of ``x`` that share one row of ``mask``: 1 for an
    elementwise mask, the positions of a sample for a per-sample one."""
    if mask is None:
        return 1
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    c = x.shape[-1]
    if mask.numel() == x.numel():
        return 1
    if mask.numel() == x.shape[0] * c and mask.shape[-1] == c:
        return x.numel() // mask.numel()
    raise ValueError(f"mask {tuple(mask.shape)} fits neither x "
                     f"{tuple(x.shape)} nor one bit per (sample, channel)")


def _mask_view(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if mask.numel() == x.numel():
        return mask.reshape(x.shape)
    return mask.reshape(x.shape[0], *([1] * (x.ndim - 2)), x.shape[-1])


# ---------------------------------------------------------------------------
# launch plans: pure functions of (_Geom, dtype), no tensor touched
# ---------------------------------------------------------------------------
#
# A forward or an input-gradient launch is an implicit GEMM.  A block owns
# a tile of whole rows of W positions (or, past 1,024 positions a row, a
# strip of one row with its halo) and stages the operand tile once, with
# the prologue (forward) or the cotangent (input gradient) applied per
# element.  Its "A side" is what the taps read (x, or the cotangent), its
# "N side" what it writes.  Channels of a group are padded in shared
# memory only: the reduction to ``kpad`` (16), the outputs to ``npad`` (8).
# Weights enter shared memory in chunks of ``tnc`` output columns; narrow
# and grouped stages hold all of theirs for the block's life.

_PATH_CODES = {"direct": 0, "mma": 1, "fma": 2, "mma_stream": 3}
_MAX_TILE = 1024    # output positions of one tile (64 row tiles of 16)
_STREAM_TILE = 80   # the same on the streaming path (5 row tiles)
_STREAM_COLS = 64   # columns of a chunk of streamed weights: 8 a warp
_STREAM_DEPTH = 32  # reduction depth of a streamed weight tile
_STREAM_STAGES = 4
_MAX_DIRECT_CO = 8
_WEIGHT_TILE = 72 * 1024   # bytes of one chunk of weights in shared memory


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ConvPlan(NamedTuple):
    """One forward or input-gradient launch."""
    path: str        # "direct" | "mma", "mma_stream" (bf16, tensor cores)
    #                  | "fma" (fp32, CUDA cores)
    rows: int        # whole rows of a tile (1 when a row is cut in strips)
    strip: int       # output positions of a strip (the row's, if uncut)
    strips: int      # strips a row
    arows: int       # A-side positions staged per tile (+ 1 zero row)
    gpb: int         # groups a block
    kpad: int        # A-side channels of a group, padded to 16
    npad: int        # N-side channels of a group, padded to 8
    tnc: int         # N-side columns per weight chunk
    nchunks: int
    nt: int          # 8-column tiles per warp unit
    mtiles: int      # 16-position tiles of a tile
    vec: int         # A-side channels per staged vector (4 or 1)
    smem: int        # bytes of dynamic shared memory
    grid_x: int
    grid_y: int

    def ints(self) -> Tuple[int, ...]:
        return (_PATH_CODES[self.path], self.rows, self.strip, self.strips,
                self.arows, self.gpb, self.kpad, self.npad, self.tnc,
                self.nchunks, self.nt, self.mtiles, self.vec, self.smem,
                self.grid_x)


class WgradPlan(NamedTuple):
    """One weight-gradient launch: the GEMM with positions as K."""
    path: str        # "mma" | "fma"
    rows: int        # whole rows of one reduction step
    strip: int
    strips: int
    arows: int       # activation positions staged per step (+ 1 zero row)
    kp: int          # output positions per step, padded to 16
    tmw: int         # output channels of a tile (M)
    tnw: int         # input channels of a tile (N), all taps
    ntm: int
    ntn: int
    splits: int      # blocks that share the positions
    steps_per_split: int
    vec_g: int
    vec_a: int
    smem: int

    def ints(self) -> Tuple[int, ...]:
        return (_PATH_CODES[self.path], self.rows, self.strip, self.strips,
                self.arows, self.kp, self.tmw, self.tnw, self.ntm, self.ntn,
                self.splits, self.steps_per_split, self.vec_g, self.vec_a,
                self.smem)


class StagePlan(NamedTuple):
    fwd: ConvPlan
    dgrad: ConvPlan
    wgrad: WgradPlan


def _esize(dtype: torch.dtype) -> int:
    dtype_code(dtype)
    return 2 if dtype == torch.bfloat16 else 4


def _halo(g: _Geom, strip: int, dgrad: bool) -> int:
    """A-side positions that ``strip`` output positions of one row read."""
    reach = (g.ktaps - 1) * g.dil
    if dgrad:
        return (strip - 1 + reach) // g.stride + 1
    return (strip - 1) * g.stride + reach + 1


def _conv_smem(esize, arows, ktaps, gpb, kpad, tnc, nchunks, mtiles) -> int:
    pad = 16 // esize
    lda, ldb = gpb * kpad + pad, ktaps * kpad + pad
    return (_up((arows + 1) * lda * esize, 16) + _up(tnc * ldb * esize, 16)
            + (ktaps + 1) * mtiles * 16 * 4 + 2 * mtiles * tnc * 4
            + 2 * nchunks * tnc * 4)


def _too_big(what: str, g: _Geom, smem: int):
    return ValueError(
        f"stage {what}: {smem} bytes of shared memory for {g} exceed the "
        f"{SMEM_LIMIT} a block may use")


def _grid_x(tiles: int, grid_y: int, smem: int) -> int:
    """Blocks that walk ``tiles``: as many as the card holds at once, two
    an SM where their shared memory lets two share one."""
    per_sm = 2 if 2 * smem <= SMEM_LIMIT else 1
    return min(tiles, max(1, per_sm * _SMS // grid_y))


def _pick_rows(g: _Geom, wo: int, grid_y: int, smem_of,
               max_tile: int = _MAX_TILE) -> int:
    """Whole rows a tile: the best product of how full its 16-position
    tiles are, how many of the card's SMs the launch reaches, and how
    evenly the tiles divide over the blocks."""
    best, best_score = 0, -1.0
    for rows in range(1, max(1, min(g.rows, max_tile // wo)) + 1):
        smem = smem_of(rows)
        if smem > SMEM_LIMIT:
            break
        tiles = _cdiv(g.rows, rows)
        grid_x = _grid_x(tiles, grid_y, smem)
        fill = rows * wo / _up(rows * wo, 16)
        reach = min(1.0, grid_x * grid_y / (2 * _SMS))
        even = tiles / (_cdiv(tiles, grid_x) * grid_x)
        if fill * reach * even >= best_score:
            best, best_score = rows, fill * reach * even
    return best


_STRIPS = (1024, 512, 256, 128, 64, 32, 16)


def _pick_tile(g: _Geom, wa: int, wo: int, grid_y: int, dgrad: bool, smem_of,
               max_tile: int = _MAX_TILE):
    """``(rows, strip, strips, arows)`` of a tile that fits the card's
    shared memory: whole rows where one fits, else the longest strip of a
    row (with its halo) that does; None if none does."""
    if wo <= max_tile:
        rows = _pick_rows(g, wo, grid_y, lambda r: smem_of(r, wo, r * wa),
                          max_tile)
        if rows:
            return rows, wo, 1, rows * wa
    for strip in _STRIPS:
        arows = _halo(g, strip, dgrad)
        if (strip <= max_tile and strip < wo
                and smem_of(1, strip, arows) <= SMEM_LIMIT):
            return 1, strip, _cdiv(wo, strip), arows
    return None


@functools.lru_cache(maxsize=None)
def _plan_stream(g: _Geom, dgrad: bool) -> Optional[ConvPlan]:
    """A dense pointwise bf16 stage whose weights do not fit shared
    memory: they stream through a ring of fp32 tiles.  None if no tile of
    positions fits beside the ring."""
    ca, cn = (g.co, g.ci) if dgrad else (g.ci, g.co)
    wa, wo = (g.wout, g.win) if dgrad else (g.win, g.wout)
    kpad, nchunks = _up(ca, 16), _cdiv(cn, _STREAM_COLS)
    # a warp's slice of a weight tile in floats, padded against bank
    # conflicts, in a ring of its own
    piece = _STREAM_DEPTH * (8 + 4) if dgrad else 8 * (_STREAM_DEPTH + 8)
    ring = (_THREADS // 32) * _STREAM_STAGES * piece * 4

    def smem_of(rows, strip, arows):
        return (_up((arows + 1) * (kpad + 8) * 2, 16) + ring
                + 2 * _cdiv(rows * strip, 16) * 16 * 4
                + 2 * nchunks * _STREAM_COLS * 4)

    # up to four blocks share the column chunks of a row tile (below)
    tile = _pick_tile(g, wa, wo, min(nchunks, 4), dgrad, smem_of,
                      _STREAM_TILE)
    if tile is None:
        return None
    rows, strip, strips, arows = tile
    tiles = _cdiv(g.rows, rows) * strips
    grid_x = min(tiles, 4 * _SMS)
    # the column chunks of a row tile are split over blocks (``nt`` and
    # ``grid_y`` on this path) until two blocks share every SM: a block's
    # time is the weight tiles it walks, one after the other
    per_sm = 2 if 2 * smem_of(rows, strip, arows) <= SMEM_LIMIT else 1
    nsplit = max(1, min(nchunks, per_sm * _SMS // grid_x))
    return ConvPlan("mma_stream", rows, strip, strips, arows, 1, kpad,
                    _up(cn, 8), _STREAM_COLS, nchunks, nsplit,
                    _cdiv(rows * strip, 16), 4, smem_of(rows, strip, arows),
                    grid_x, nsplit)


@functools.lru_cache(maxsize=None)
def _plan_conv(g: _Geom, esize: int, dgrad: bool) -> ConvPlan:
    cig, cog = g.ci // g.groups, g.co // g.groups
    ca, cn = (cog, cig) if dgrad else (cig, cog)
    wa, wo = (g.wout, g.win) if dgrad else (g.win, g.wout)
    if not dgrad and g.ci == 1 and g.co <= _MAX_DIRECT_CO:
        npos = g.rows * g.wout
        grid_x = min(_cdiv(npos, _THREADS), 8 * _SMS)
        return ConvPlan("direct", _cdiv(npos, grid_x), 0, 1, 0, 1, 0, 0, 0,
                        1, 0, 0, 1, 0, _cdiv(npos, _cdiv(npos, grid_x)), 1)
    path = "mma" if esize == 2 else "fma"
    kpad, npad = _up(ca, 16), _up(cn, 8)
    ldb = g.ktaps * kpad + 16 // esize
    gpb = 1
    if g.groups > 1:
        gpb = max(d for d in range(1, g.groups + 1) if g.groups % d == 0
                  and (d == 1 or (d * npad <= 128 and d * kpad <= 256)))
    grid_y = g.groups // gpb
    if gpb > 1 or npad * ldb * esize <= _WEIGHT_TILE:
        tnc = gpb * npad
    elif (esize == 2 and g.groups == 1 and g.ktaps == 1 and g.ci % 4 == 0
          and g.co % 4 == 0 and _plan_stream(g, dgrad) is not None):
        return _plan_stream(g, dgrad)
    else:
        tnc = max(8, min(64, _WEIGHT_TILE // (ldb * esize) // 8 * 8))
    while True:
        nchunks = 1 if gpb > 1 else _cdiv(npad, tnc)

        def smem_of(rows, strip, arows):
            return _conv_smem(esize, arows, g.ktaps, gpb, kpad, tnc, nchunks,
                              _cdiv(rows * strip, 16))

        tile = _pick_tile(g, wa, wo, grid_y, dgrad, smem_of)
        if tile:
            rows, strip, strips, arows = tile
            break
        if gpb > 1 or tnc == 8:
            raise _too_big("input gradient" if dgrad else "forward", g,
                           smem_of(1, 16, _halo(g, 16, dgrad)))
        tnc = max(8, tnc // 2 // 8 * 8)
    mtiles = _cdiv(rows * strip, 16)
    # the 8-column tiles a warp unit takes: the fewest fragment loads and
    # products on the busiest of the 8 warps
    ntg = (npad if gpb > 1 else tnc) // 8
    nt = min((4, 2, 1), key=lambda t: (
        _cdiv(mtiles * gpb * _cdiv(ntg, t), 8) * (2 * t + 1), -t))
    tiles, smem = _cdiv(g.rows, rows) * strips, smem_of(rows, strip, arows)
    return ConvPlan(path, rows, strip, strips, arows, gpb, kpad, npad, tnc,
                    nchunks, nt, mtiles, 4 if ca % 4 == 0 else 1, smem,
                    _grid_x(tiles, grid_y, smem), grid_y)


_WGRAD_UNITS = 12   # 16 x 8 tiles of the weight gradient that a warp holds


def _wgrad_smem(esize, arows, kp, ktaps, tmw, tnw) -> int:
    pad = 16 // esize
    total = (_up(kp * (tmw + pad) * esize, 16)
             + _up((arows + 1) * (tnw + pad) * esize, 16) + ktaps * kp * 4
             + _THREADS * 4 * 4)
    units = (tmw // 16) * (tnw // 8) * ktaps
    if esize == 2 and units <= _WGRAD_UNITS:
        # the warps split the positions and add their tiles at the end
        total = max(total, 8 * units * 512)
    return total


@functools.lru_cache(maxsize=None)
def _plan_wgrad(g: _Geom, esize: int) -> WgradPlan:
    cig, cog = g.ci // g.groups, g.co // g.groups
    if esize == 2:
        # M in whole warps' worth of 16-row tiles (a power of two, so that
        # a warp keeps one row tile); N and the taps fill a warp's 12 units
        # Every tile of output channels stages the activation again and
        # every tile of input channels the cotangent: tiles as large as a
        # warp's accumulators allow.
        tmw = next((t for t in (16, 32, 64, 128) if cog <= t), 0) or (
            128 if _up(cog, 128) <= 1.2 * cog else 64)
        wide = _WGRAD_UNITS * (8 // (tmw // 16)) // g.ktaps * 8
        tnw = _up(_cdiv(cig, _cdiv(cig, wide)), 8)
    else:
        # a thread holds 4 x 4 channels of every tap: 256 threads, 64 x 64
        tmw, tnw = min(64, _up(cog, 4)), min(64, _up(cig, 4))
    ntm, ntn = _cdiv(cog, tmw), _cdiv(cig, tnw)

    def smem_of(rows, strip, arows):
        return _wgrad_smem(esize, arows, _up(rows * strip, 16), g.ktaps, tmw,
                           tnw)

    tile = None
    if g.wout <= _MAX_TILE:
        # whole rows: the most positions a step that waste the fewest
        rows_max = max(1, min(g.rows, _MAX_TILE // g.wout))
        fits = [r for r in range(1, rows_max + 1)
                if 2 * smem_of(r, g.wout, r * g.win) <= SMEM_LIMIT] or [
            r for r in range(1, rows_max + 1)
            if smem_of(r, g.wout, r * g.win) <= SMEM_LIMIT]
        # enough steps for the blocks that will share the positions
        want = _cdiv(2 * _SMS, g.groups * ntm * ntn)
        fits = [r for r in fits if _cdiv(g.rows, r) >= want] or fits[:1]
        if fits:
            rows = max(fits, key=lambda r: (
                r * g.wout / _up(r * g.wout, 16), r))
            tile = rows, g.wout, 1, rows * g.win
    for strip in () if tile else _STRIPS:
        arows = _halo(g, strip, False)
        if strip < g.wout and smem_of(1, strip, arows) <= SMEM_LIMIT:
            tile = 1, strip, _cdiv(g.wout, strip), arows
            break
    if tile is None:
        raise _too_big("weight gradient", g,
                       smem_of(1, 16, _halo(g, 16, False)))
    rows, strip, strips, arows = tile
    steps = _cdiv(g.rows, rows) * strips
    tiles = g.groups * ntm * ntn
    splits = min(steps, max(1, _cdiv(2 * _SMS, tiles)))
    per = _cdiv(steps, splits)
    return WgradPlan("mma" if esize == 2 else "fma", rows, strip, strips,
                     arows, _up(rows * strip, 16), tmw, tnw, ntm, ntn,
                     _cdiv(steps, per), per, 4 if cog % 4 == 0 else 1,
                     4 if cig % 4 == 0 else 1, smem_of(rows, strip, arows))


def stage_plan(g: _Geom, dtype: torch.dtype) -> StagePlan:
    """How the three kernels of one stage are launched: path, tiles,
    padding, shared memory and grid.  Raises when a tile cannot fit the
    card's shared memory."""
    esize = _esize(dtype)
    return StagePlan(_plan_conv(g, esize, False), _plan_conv(g, esize, True),
                     _plan_wgrad(g, esize))


class Tile(NamedTuple):
    """What one block step works on: rows ``[row0, row0 + rows)``, output
    positions ``[w0, w0 + width)`` of each, and the A-side positions
    ``[a_lo, a_lo + a_count)`` of each row that it stages."""
    row0: int
    rows: int
    w0: int
    width: int
    a_lo: int
    a_count: int


def plan_tiles(g: _Geom, plan, dgrad: bool = False):
    """The tiles of a :class:`ConvPlan` (or the reduction steps of a
    :class:`WgradPlan`, with ``dgrad=False``) in the kernels' order."""
    wa, wo = (g.wout, g.win) if dgrad else (g.win, g.wout)
    for t in range(_cdiv(g.rows, plan.rows) * plan.strips):
        row0 = t // plan.strips * plan.rows
        w0 = t % plan.strips * plan.strip
        width = min(plan.strip, wo - w0)
        a_lo, a_count = 0, wa
        if plan.strips > 1:
            if dgrad:
                lo = -((-(w0 - (g.ktaps - 1 - g.pad) * g.dil)) // g.stride)
                hi = (w0 + width - 1 + g.pad * g.dil) // g.stride
            else:
                lo = w0 * g.stride - g.pad * g.dil
                hi = ((w0 + width - 1) * g.stride
                      + (g.ktaps - 1 - g.pad) * g.dil)
            a_lo = max(lo, 0)
            a_count = max(0, min(hi, wa - 1) - a_lo + 1)
        yield Tile(row0, min(plan.rows, g.rows - row0), w0, width, a_lo,
                   a_count)


def stage_geometry(kind: str, lead: Tuple[int, ...], ci: int, co: int,
                   groups: int = 1, dil: int = 1) -> _Geom:
    """The geometry of ``stage`` on an input ``[*lead, ci]``."""
    if kind not in _KINDS:
        raise ValueError(f"stage kind {kind!r}: one of {sorted(_KINDS)}")
    ktaps, stride, pad = _KINDS[kind]
    rows = 1
    for n in lead[:-1]:
        rows *= n
    win = lead[-1]
    return _Geom(rows, win, (win - 1) // stride + 1, ci, co, groups, ktaps,
                 stride, dil if kind == "causal3" else 1, pad)


def step_launches(cfg, batch: int):
    """The ``stage`` and ``join`` launches of one fused train step of
    ``cfg`` at ``batch``, in the model's order, as dicts: a stage's
    geometry, the leading shape and channels of its input, and whether it
    has a prologue, a mask (one bit per element or per (sample, channel)),
    a bias, and an input that needs a gradient.  ``cfg`` is a
    ``ModelConfig`` (the TCN reads ``num_subcarriers`` channels and the
    conv stack its last level's) or an ``MMFiModelConfig`` (the TCN reads
    ``input_channels``, 342, and the conv stack the projection's
    ``tcn_proj_channels``, 272).  The TCN's k=3 convs take the groups of
    ``cfg.tcn_conv`` where the config has that switch."""
    t, kind = cfg.window_size, getattr(cfg, "tcn_conv", "grouped")
    stages, joins = [], []

    def groups(c):
        return tcn_conv_groups(kind, cfg.tcn_groups, c)


    def stage(kind, lead, ci, co, groups=1, dil=1, pro=False, mask=None,
              bias=False, need_gx=True):
        stages.append(dict(kind=kind, lead=lead, ci=ci, co=co, groups=groups,
                           dil=dil, pro=pro, mask=mask, bias=bias,
                           need_gx=need_gx))

    cin = getattr(cfg, "input_channels", cfg.num_subcarriers)
    for i, cout in enumerate(cfg.tcn_channels):
        lead, first = (batch, t), i == 0
        if cin != cout:
            stage("identity", lead, cin, cout, need_gx=not first)
        stage("causal3", lead, cin, cin, groups(cin), 2 ** i,
              need_gx=not first)
        stage("identity", lead, cin, cout, pro=True)
        stage("causal3", lead, cout, cout, groups(cout), 2 ** i, pro=True,
              mask="element")
        stage("identity", lead, cout, cout, pro=True)
        joins.append(dict(lead=lead, c=cout, mask="element",
                          res_norm=cin != cout, act_h=True))
        cin = cout
    # the conv stack's input comes from the TCN or the projection, which
    # have parameters: every stage of it needs its input's gradient
    w = getattr(cfg, "tcn_proj_channels", cfg.tcn_channels[-1])
    ci = 1
    for k, co in enumerate((cfg.conv_channels[0],) + tuple(cfg.conv_channels)):
        strided = k > 0
        wout = (w - 1) // 2 + 1 if strided else w
        stage("chunk1" if strided else "identity", (batch, t, w), ci, co)
        stage("chunk3" if strided else "sym3", (batch, t, w), ci, co,
              bias=True)
        for _ in range(2):
            stage("sym3", (batch, t, wout), co, co, pro=True, mask="sample",
                  bias=True)
        joins.append(dict(lead=(batch, t, wout), c=co, mask=None,
                          res_norm=True, act_h=False))
        ci, w = co, wout
    return stages, joins


def mmfi_stage_cases(batch: int):
    """Stage launches at the MM-Fi model's geometries (``T = 10``; 19, 17
    and 16 channels a group of 18; the projection to 272; conv rows of 272,
    68, 34 and 17 positions), as :func:`step_launches` describes them."""
    def case(kind, lead, ci, co, groups=1, dil=1, pro=False, mask=None,
             bias=False):
        return dict(kind=kind, lead=lead, ci=ci, co=co, groups=groups,
                    dil=dil, pro=pro, mask=mask, bias=bias, need_gx=True)

    tcn, conv = (batch, 10), lambda w: (batch, 10, w)
    return [
        case("causal3", tcn, 342, 342, 18, 1, pro=True, mask="element"),
        case("identity", tcn, 342, 306, pro=True),
        case("causal3", tcn, 306, 306, 18, 2, pro=True, mask="element"),
        case("causal3", tcn, 288, 288, 18, 4),
        case("identity", tcn, 288, 272, pro=True),
        case("sym3", conv(272), 1, 8, bias=True),
        case("sym3", conv(272), 8, 8, pro=True, mask="sample", bias=True),
        case("chunk3", conv(272), 8, 16, bias=True),
        case("chunk1", conv(272), 8, 16),
        case("chunk3", conv(68), 32, 64, bias=True),
        case("sym3", conv(17), 64, 64, pro=True, mask="sample", bias=True),
    ]


# ---------------------------------------------------------------------------
# the join's launch plan: a pure function of the shape and the dtype
# ---------------------------------------------------------------------------
#
# A row of C channels is C / vec chunks, one aligned load each; a thread
# owns one chunk for the whole launch.  A block takes ``cols`` chunks of a
# row (its slice) and ``rows`` rows a pass, and each thread keeps the
# copies of ``stages`` - 1 rows in flight (a ring in shared memory) while
# it computes one.  The backward's last block of each slice sums that
# slice's partials, one float4 a channel and block, so the backward cuts a
# row into slices until that sum is small.

_JOIN_THREADS = 256       # a block's most threads, rows x cols
_JOIN_STAGES = 2          # the kernels' ring of rows a thread
_JOIN_FINISH = 2048       # most float4 partials one block sums (32 KB)
_JOIN_BACKWARD_VEC = 4    # the backward's widest chunk, in channels
_SECTOR = 32              # bytes: a slice is at least this much of a row


class JoinPlan(NamedTuple):
    """One launch of ``csrc/join_fused.cu``, forward or backward."""
    vec: int          # channels a chunk: the widest of 8, 4, 2, 1 (bf16;
    #                   4, 2, 1 in fp32) that divides C, 16 bytes at most,
    #                   and at most 4 in the backward
    groups: int       # chunks a row, C / vec
    cols: int         # chunks of a row a block takes: its slice
    slices: int       # blocks across a row, ceil(groups / cols)
    rows: int         # rows a pass of a block, 256 // cols
    threads: int      # rows x cols
    stages: int       # rows a thread has in flight, the one it computes too
    grid: int         # blocks along the rows, persistent; the backward's
    #                   rows of fp32 partials

    def ints(self) -> Tuple[int, ...]:
        """The C side's ``v, cols, rows, slices, stages, grid_x``."""
        return (self.vec, self.cols, self.rows, self.slices, self.stages,
                self.grid)


def join_blocks_per_sm(vec: int, esize: int, backward: bool) -> int:
    """Blocks an SM at the kernels' launch bounds: 3 where a chunk is at
    most 8 bytes (forward) or 4 channels (backward), else 2."""
    return 3 if (vec <= 4 if backward else vec * esize <= 8) else 2


def _join_shape(npos: int, c: int, dtype: torch.dtype,
                backward: bool) -> Tuple[int, int]:
    esize = _esize(dtype)
    if npos < 1 or c < 1 or npos * c >= 2 ** 31:
        raise ValueError(f"join takes 1 <= positions x channels < 2^31, got "
                         f"{npos} x {c}")
    most = min(16 // esize, _JOIN_BACKWARD_VEC if backward else 8)
    return esize, next(v for v in (8, 4, 2, 1) if v <= most and c % v == 0)


def join_plan_at(npos: int, c: int, dtype: torch.dtype, backward: bool,
                 slices: int, sms: int = _SMS) -> JoinPlan:
    """A ``join`` launch on ``npos`` rows of ``c`` channels with each row
    cut in (at most) ``slices`` slices."""
    _, vec = _join_shape(npos, c, dtype, backward)
    groups = c // vec
    cols = _cdiv(groups, max(1, min(slices, groups)))
    if cols * vec > _JOIN_THREADS:
        raise ValueError(f"a slice of {cols * vec} channels is more than a "
                         f"block's {_JOIN_THREADS}")
    slices, rows = _cdiv(groups, cols), _JOIN_THREADS // cols
    grid = min(_cdiv(npos, rows),
               _cdiv(join_blocks_per_sm(vec, _esize(dtype), backward) * sms,
                     slices))
    return JoinPlan(vec, groups, cols, slices, rows, rows * cols,
                    _JOIN_STAGES, grid)


@functools.lru_cache(maxsize=None)
def join_plan(npos: int, c: int, dtype: torch.dtype, backward: bool,
              sms: int = _SMS) -> JoinPlan:
    """The ``join`` forward or backward launch on ``npos`` rows of ``c``
    channels.  Pure: the CPU tests hold it.

    A persistent grid of 3 blocks an SM (2 for a forward of 16-byte
    chunks, :func:`join_blocks_per_sm`) walks the rows, a pass of ``rows``
    rows at a time.  A slice is at most 256 channels: the forward takes the
    fewest slices a row (whole rows up to 256 channels), the backward the
    fewest at which its last block of a slice sums at most 2,048 float4
    partials, not cut below 32 bytes of a row.  The mask and the residual
    norm are read at run time and do not change the launch."""
    esize, vec = _join_shape(npos, c, dtype, backward)
    groups, plan = c // vec, None
    for slices in range(1, groups + 1):
        cols = _cdiv(groups, slices)
        if plan is not None and cols * vec * esize < _SECTOR:
            break
        if cols * vec > _JOIN_THREADS or (plan and cols == plan.cols):
            continue
        plan = join_plan_at(npos, c, dtype, backward, slices, sms)
        if not backward or plan.grid * cols * vec <= _JOIN_FINISH:
            break
    return plan


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc(t: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or float64 for float64 inputs."""
    return t if t.dtype == torch.float64 else t.float()


def _silu(u: torch.Tensor) -> torch.Tensor:
    uf = _acc(u)
    return (uf * torch.sigmoid(uf)).to(u.dtype)


def _norm(x: torch.Tensor, m, a, b) -> torch.Tensor:
    dt = x.dtype
    return (x - m.to(dt)) * a.to(dt) + b.to(dt)


def _drop(act: torch.Tensor, mask: Optional[torch.Tensor],
          keep: float) -> torch.Tensor:
    if mask is None:
        return act
    return torch.where(_mask_view(mask, act), act / keep,
                       torch.zeros((), dtype=act.dtype, device=act.device))


def stage_plain(x: torch.Tensor, m, a, b, mask, weight: torch.Tensor, bias,
                *, kind: str, dil: int = 1, keep: float = 1.0,
                stats: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`stage` in stock torch ops, with the kernels' rounding
    points: the prologue in ``x.dtype`` with the sigmoid in fp32, the sums
    from the output as rounded to ``x.dtype``."""
    g = _geometry(x, weight, kind, dil)
    _mask_div(mask, x)
    dt = x.dtype
    act = x if a is None else _silu(_norm(x, m, a, b))
    act = _drop(act, mask, keep)
    rows = act.reshape(g.rows, g.win, g.ci).transpose(1, 2)   # [R, Ci, W]
    w = weight.reshape(g.co, g.ci // g.groups, g.ktaps).to(dt)
    stride, pad = g.stride, g.pad
    if kind == "causal3":
        rows, pad = F.pad(rows, (g.pad * g.dil, 0)), 0
    elif g.ktaps == 1 and stride > 1:
        # the stride as a slice, as ops/conv.py::conv1x1_2d takes it
        rows, stride = rows[:, :, ::stride], 1
    out = F.conv1d(rows, w, None if bias is None else bias.to(dt),
                   stride=stride, padding=pad, dilation=g.dil,
                   groups=g.groups)
    out = out.transpose(1, 2).reshape(*x.shape[:-2], g.wout, g.co)
    if not stats:
        return out, None
    of = _acc(out).reshape(-1, g.co)
    return out, torch.stack([of.sum(0), (of * of).sum(0)])


def join_plain(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor,
               m_r=None, a_r=None, b_r=None, *, keep: float = 1.0,
               act_h: bool = True) -> torch.Tensor:
    """:func:`join` in stock torch ops."""
    _mask_div(mask, h)
    v = _norm(h, m_h, a_h, b_h)
    if act_h:
        v = _silu(v)
    v = _drop(v, mask, keep)
    r = res if a_r is None else _norm(res, m_r, a_r, b_r)
    return _silu(v + r)


def join_backward_rounded(h: torch.Tensor, m_h, a_h, b_h, mask,
                          res: torch.Tensor, m_r, a_r, b_r, go: torch.Tensor,
                          *, keep: float = 1.0, act_h: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gh, gres)`` of :func:`join` as the kernels specify them, in fp32:
    the chain rule in fp32 on the forward's values rounded to ``h.dtype``
    where :func:`join_plain` in that dtype rounds them (each step of a norm,
    the SiLU of h, the division by ``keep``, the sum), the sigmoids in fp32
    on the rounded values, the scales ``a`` rounded.  In bf16 this is the
    JAX package's rounding too (its Pallas ``join`` VJP); autograd of the
    bf16 plain version rounds each intermediate of the backward as well."""
    dt = h.dtype

    def rt(x):
        return x.to(dt).float()

    def norm(x, m, a, b):
        return rt(rt(rt(x - rt(m)) * rt(a)) + rt(b))

    def dsilu(u, sig):
        return sig * (1 + u * (1 - sig))

    zero = torch.zeros((), device=h.device)
    uh = norm(h.float(), m_h, a_h, b_h)
    sig_h = torch.sigmoid(uh)
    v = rt(uh * sig_h) if act_h else uh
    if mask is not None:
        mask = _mask_view(mask, h)
        v = torch.where(mask, rt(v / keep), zero)
    r = res.float() if a_r is None else norm(res.float(), m_r, a_r, b_r)
    s = rt(v + r)
    gv = go.float() * dsilu(s, torch.sigmoid(s))
    gres = gv if a_r is None else gv * rt(a_r)
    gu = gv if mask is None else torch.where(mask, gv / keep, zero)
    if act_h:
        gu = gu * dsilu(uh, sig_h)
    return gu * rt(a_h), gres


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _vec(t: Optional[torch.Tensor], name: str, dev, c: int):
    if t is None:
        return None
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.float()
    t = t.contiguous()
    check_tensor(t, name, device=dev, dtype=torch.float32, shape=(c,))
    return t


def _prologue(m, a, b, dev, c: int, what: str):
    if (m is None) != (a is None) or (a is None) != (b is None):
        raise ValueError(f"{what}: give all of m, a, b or none")
    return (_vec(m, f"{what} m", dev, c), _vec(a, f"{what} a", dev, c),
            _vec(b, f"{what} b", dev, c))


def _mask_arg(mask, x):
    div = _mask_div(mask, x)
    if mask is None:
        return None, 1
    if mask.device != x.device:
        raise ValueError(f"mask is on {mask.device}, expected {x.device}")
    return _aligned(mask.contiguous()), div


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` at an address the kernels' 16-byte vector loads can take."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def stage_forward(x: torch.Tensor, m, a, b, mask, weight: torch.Tensor, bias,
                  *, kind: str, dil: int = 1, keep: float = 1.0,
                  stats: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel (and, with ``stats``, its float64
    reduction over blocks)."""
    g = _geometry(x, weight, kind, dil)
    dev, dt = x.device, x.dtype
    code = dtype_code(dt)
    plan = _plan_conv(g, _esize(dt), False)
    x = _aligned(x.contiguous())
    m, a, b = _prologue(m, a, b, dev, g.ci, "stage")
    mask, div = _mask_arg(mask, x)
    w = _aligned(_vec(weight.reshape(-1), "weight", dev, weight.numel()))
    bias = _vec(bias, "bias", dev, g.co)
    out = torch.empty((*x.shape[:-2], g.wout, g.co), device=dev, dtype=dt)
    partial = sums = None
    if stats:
        partial = torch.empty((plan.grid_x, 2, g.co), device=dev,
                              dtype=torch.float32)
        sums = torch.empty((2, g.co), device=dev, dtype=torch.float32)
    STAGE_FORWARD.launch(code, ptr(x), ptr(m), ptr(a), ptr(b), ptr(mask), div,
                         keep, ptr(w), ptr(bias), ptr(out), ptr(partial),
                         ptr(sums), *g, *plan.ints(), stream_ptr(dev))
    return out, sums


def stage_backward(x: torch.Tensor, m, a, b, mask, weight: torch.Tensor,
                   out: Optional[torch.Tensor], go: torch.Tensor,
                   gsums: Optional[torch.Tensor], *, kind: str, dil: int = 1,
                   keep: float = 1.0, has_bias: bool = False,
                   need_gx: bool = True):
    """One launch of the backward kernels (input gradient with the
    prologue sums, weight gradient, and their float64 reductions).

    ``out`` and ``gsums [2, Co]`` carry the cotangent of the sums (both or
    neither).  Returns ``(gx, gmab, gw, gbias)``: ``gx`` in ``x.dtype`` (None
    without ``need_gx``), ``gmab [3, Ci]`` fp32 = (g_m, g_a, g_b) (None
    without a prologue or ``need_gx``), ``gw`` fp32 in ``weight``'s shape,
    ``gbias [Co]`` fp32 or None.
    """
    g = _geometry(x, weight, kind, dil)
    dev, dt = x.device, x.dtype
    code = dtype_code(dt)
    esize = _esize(dt)
    pd, pw = _plan_conv(g, esize, True), _plan_wgrad(g, esize)
    x = _aligned(x.contiguous())
    m, a, b = _prologue(m, a, b, dev, g.ci, "stage")
    mask, div = _mask_arg(mask, x)
    w = _aligned(_vec(weight.reshape(-1), "weight", dev, weight.numel()))
    oshape = (*x.shape[:-2], g.wout, g.co)
    go = _aligned(go.contiguous())
    check_tensor(go, "go", device=dev, dtype=dt, shape=oshape)
    if (out is None) != (gsums is None):
        raise ValueError("give both out and gsums, or neither")
    if gsums is not None:
        out = _aligned(out.contiguous())
        check_tensor(out, "out", device=dev, dtype=dt, shape=oshape)
        gsums = _vec(gsums.reshape(-1), "gsums", dev, 2 * g.co)

    gx = partial_ab = gmab = None
    if need_gx:
        gx = torch.empty_like(x)
        if a is not None:
            partial_ab = torch.empty((pd.grid_x, 2, g.ci), device=dev,
                                     dtype=torch.float32)
            gmab = torch.empty((3, g.ci), device=dev, dtype=torch.float32)
    nw = weight.numel()
    ldw = nw + (g.co if has_bias else 0)
    partial_w = torch.empty((pw.splits, ldw), device=dev, dtype=torch.float32)
    gwb = torch.empty((ldw,), device=dev, dtype=torch.float32)
    # The input gradient's epilogue recomputes the prologue anyway, so it
    # leaves the activation in device memory for the weight gradient to
    # copy.  A dense stage's weight gradient would also form the cotangent
    # once per tile of channels: there the streaming input gradient leaves
    # that too (not with a bias, whose gradient needs it before rounding).
    g_made = act_made = None
    if need_gx and (a is not None or mask is not None):
        act_made = torch.empty_like(x)
    if (need_gx and pd.path == "mma_stream" and not has_bias
            and pw.ntm * pw.ntn > 1):
        g_made = torch.empty_like(go)
    STAGE_BACKWARD.launch(code, ptr(x), ptr(m), ptr(a), ptr(b), ptr(mask),
                          div, keep, ptr(w), ptr(out), ptr(go), ptr(gsums),
                          ptr(gx), ptr(partial_ab), ptr(gmab),
                          ptr(partial_w), ptr(gwb), ptr(g_made),
                          ptr(act_made), ldw, *g, *pd.ints(), *pw.ints(),
                          stream_ptr(dev))
    gw = gwb[:nw].view(weight.shape)
    return gx, gmab, gw, (gwb[nw:] if has_bias else None)


def _join_args(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r):
    """The join's operands, checked; the vectors fp32 and contiguous."""
    dev, dt = h.device, h.dtype
    c = h.shape[-1]
    h = _aligned(h.contiguous())
    res = _aligned(res.contiguous())
    check_tensor(res, "res", device=dev, dtype=dt, shape=h.shape)
    vh = _prologue(m_h, a_h, b_h, dev, c, "join h")
    if vh[1] is None:
        raise ValueError("join: m_h, a_h, b_h are required")
    vr = _prologue(m_r, a_r, b_r, dev, c, "join res")
    mask, div = _mask_arg(mask, h)
    return h, vh, mask, div, res, vr


# The backward's workspace by (device, stream, partial rows, channels,
# slices): fp32 partials and an int32 count a slice of the blocks done,
# which the last block of each slice sets back to 0.  The launches that
# share one are on one stream (a train step's), so they run one after
# another; a CUDA graph that launches the backward holds the workspace of
# its capture stream, made by an eager call before capture, and its
# replays must not overlap one another.
_JOIN_WORKSPACE: Dict[Tuple[int, int, int, int, int],
                      Tuple[torch.Tensor, torch.Tensor]] = {}


def _join_workspace(dev: torch.device, stream: int, plan: JoinPlan, c: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream, plan.grid, c, plan.slices)
    ws = _JOIN_WORKSPACE.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "join_backward: no workspace for this stream and plan; call "
                "it once on the capture stream before capturing a CUDA graph")
        ws = _JOIN_WORKSPACE[key] = (
            torch.empty((plan.grid, c, 4), device=dev,
                        dtype=torch.float32),
            torch.zeros((plan.slices,), device=dev, dtype=torch.int32))
    return ws


def join_forward(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor,
                 m_r=None, a_r=None, b_r=None, *, keep: float = 1.0,
                 act_h: bool = True) -> torch.Tensor:
    """One launch of the forward kernel."""
    h, vh, mask, div, res, vr = _join_args(h, m_h, a_h, b_h, mask, res, m_r,
                                           a_r, b_r)
    c = h.shape[-1]
    plan = join_plan(h.numel() // c, c, h.dtype, False)
    out = torch.empty_like(h)
    JOIN_FORWARD.launch(dtype_code(h.dtype), ptr(h), *map(ptr, vh), ptr(mask),
                        div, keep, ptr(res), *map(ptr, vr), int(act_h),
                        ptr(out), h.numel() // c, c, *plan.ints(),
                        stream_ptr(h.device))
    return out


def join_backward(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor,
                  m_r, a_r, b_r, go: torch.Tensor, *, keep: float = 1.0,
                  act_h: bool = True):
    """One launch of the backward kernel, whose last block of each slice
    sums the blocks' partials in float64: ``(gh, gres)`` in ``h.dtype`` and
    ``gvec [2, 3, C]`` fp32, the (g_m, g_a, g_b) of the main branch and,
    with a residual norm, of the residual branch."""
    h, vh, mask, div, res, vr = _join_args(h, m_h, a_h, b_h, mask, res, m_r,
                                           a_r, b_r)
    dev, c = h.device, h.shape[-1]
    plan = join_plan(h.numel() // c, c, h.dtype, True)
    go = _aligned(go.contiguous())
    check_tensor(go, "go", device=dev, dtype=h.dtype, shape=h.shape)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    partial, counters = _join_workspace(dev, stream, plan, c)
    gh, gres = torch.empty_like(h), torch.empty_like(h)
    gvec = torch.empty((2, 3, c), device=dev, dtype=torch.float32)
    JOIN_BACKWARD.launch(dtype_code(h.dtype), ptr(h), *map(ptr, vh),
                         ptr(mask), div, keep, ptr(res), *map(ptr, vr),
                         int(act_h), ptr(go), ptr(gh), ptr(gres),
                         ptr(partial), ptr(counters), ptr(gvec),
                         h.numel() // c, c, *plan.ints(),
                         ctypes.c_void_p(stream))
    return gh, gres, gvec


def _like(grad: Optional[torch.Tensor], ref: Optional[torch.Tensor]):
    """``grad`` in the dtype of the input it belongs to."""
    if grad is None or ref is None:
        return None
    return grad if grad.dtype == ref.dtype else grad.to(ref.dtype)


class _Stage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, a, b, mask, weight, bias, kind, dil, keep, stats):
        out, sums = stage_forward(x, m, a, b, mask, weight, bias, kind=kind,
                                  dil=dil, keep=keep, stats=stats)
        ctx.save_for_backward(x, m, a, b, mask, weight, bias,
                              out if stats else None)
        ctx.opts = (kind, dil, keep)
        ctx.set_materialize_grads(False)
        return out, sums

    @staticmethod
    @once_differentiable
    def backward(ctx, go, gsums):
        x, m, a, b, mask, weight, bias, out = ctx.saved_tensors
        kind, dil, keep = ctx.opts
        if go is None:
            go = torch.zeros_like(out)
        if gsums is None:
            out = None
        need_gx = ctx.needs_input_grad[0] or (
            a is not None and any(ctx.needs_input_grad[1:4]))
        gx, gmab, gw, gbias = stage_backward(
            x, m, a, b, mask, weight, out, go, gsums, kind=kind, dil=dil,
            keep=keep, has_bias=bias is not None, need_gx=need_gx)
        gm = ga = gb = None
        if gmab is not None:
            gm, ga, gb = _like(gmab[0], m), _like(gmab[1], a), _like(gmab[2], b)
        return (gx, gm, ga, gb, None, _like(gw, weight), _like(gbias, bias),
                None, None, None, None)


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r, keep, act_h):
        ctx.save_for_backward(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r)
        ctx.opts = (keep, act_h)
        return join_forward(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r,
                            keep=keep, act_h=act_h)

    @staticmethod
    @once_differentiable
    def backward(ctx, go):
        h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r = ctx.saved_tensors
        keep, act_h = ctx.opts
        gh, gres, gvec = join_backward(h, m_h, a_h, b_h, mask, res, m_r, a_r,
                                       b_r, go, keep=keep, act_h=act_h)
        gr = (None, None, None) if a_r is None else (
            _like(gvec[1, 0], m_r), _like(gvec[1, 1], a_r),
            _like(gvec[1, 2], b_r))
        return (gh, _like(gvec[0, 0], m_h), _like(gvec[0, 1], a_h),
                _like(gvec[0, 2], b_h), None, gres, *gr, None, None)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")


def stage(x: torch.Tensor, m, a, b, mask, weight: torch.Tensor, bias, *,
          kind: str, dil: int = 1, keep: float = 1.0, stats: bool = True
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One fused train stage, differentiable in x, m, a, b, weight and
    bias: ``(out, sums [2, Co] or None)``."""
    if _on_cuda(x, "stage"):
        return _Stage.apply(x, m, a, b, mask, weight, bias, kind, dil, keep,
                            stats)
    return stage_plain(x, m, a, b, mask, weight, bias, kind=kind, dil=dil,
                       keep=keep, stats=stats)


def join(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor, m_r=None,
         a_r=None, b_r=None, *, keep: float = 1.0,
         act_h: bool = True) -> torch.Tensor:
    """The fused residual tail, differentiable in h, res and the six
    vectors."""
    if _on_cuda(h, "join"):
        return _Join.apply(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r, keep,
                           act_h)
    return join_plain(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r, keep=keep,
                      act_h=act_h)
