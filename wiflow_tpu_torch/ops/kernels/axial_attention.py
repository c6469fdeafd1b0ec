"""Fused eval dual axial attention: CUDA kernels, plain versions, packer.

Counterpart of ``wiflow_tpu/ops/pallas/axial_attention.py``, all three of
its lowerings: ``dual_axial_attention_eval_v2`` (one kernel per axis, QKV
projection inside; the default), ``dual_axial_attention_eval_fused`` (both
axes in one kernel) and ``dual_axial_attention_eval`` (v1: the projection
outside the kernel).  On ``x [B, H, W, C]``, attention runs along W
(L = W) and then along H (L = H).  Per axis, with the eval BNs folded:

    qkv = x @ Wq + bq                         bn_qkv folded into Wq, bq
    logit[g, i, j] = (q_i . k_j)_g * s_g + b_g    bn_similarity
    o = softmax_j(logit) @ v
    out = o * so + bo                         bn_output, rounded to x.dtype

Channels stay in the standard group-major order (channel = g*gc + cc):
the TPU kernel's scrambled order was a tiling choice, so the port needs no
permutation downstream.  On a CUDA tensor each axis is one launch of
``csrc/axial_attention.cu``, which reads the height axis's columns in
place through a sequence stride; on a CPU tensor the plain version runs.
The kernels that project read ``AxisWeights.wpack``, ``wq`` packed once
by :func:`axis_weights` (bf16 in tensor-core fragment order), and
:func:`attention_plan` sizes their launches; :func:`v1_plan` sizes the v1
kernel's (``csrc/axial_attention_v1.cu``: a persistent grid whose raw
tile takes the next tile's qkv rows while the core runs).

The three lowerings compute one function and differ in their rounding
points in bf16.  v2 and the fused kernel keep qkv in fp32 and round the
first axis's output to ``x.dtype`` (v2 through device memory, the fused
kernel in its on-chip intermediate); they run the same projection and
core code and agree bit for bit.  v1 also rounds qkv to ``x.dtype``,
because its projection is a ``torch.addmm`` outside the kernel whose
result the kernel reads from device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, SMS, CudaKernel, check_tensor, dtype_code, ptr, sm_count,
    stream_ptr,
)
from wiflow_tpu_torch.ops.kernels.fragments import to_fragments
from wiflow_tpu_torch.ops.norm import folded_bn

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("axial_attention", "axial_attention_forward",
                    [_I, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _I,
                     _I, _P, _P, _P, _P, ctypes.c_size_t, _P],
                    replaces="wiflow_tpu/ops/pallas/axial_attention.py:291")
KERNEL_V1 = CudaKernel("axial_attention_v1", "axial_attention_v1_forward",
                       [_I, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I,
                        _I, _P, _P, ctypes.c_size_t, _P],
                       replaces="wiflow_tpu/ops/pallas/axial_attention.py:125")
KERNEL_DUAL = CudaKernel("axial_attention_dual",
                         "axial_attention_dual_forward",
                         [_I, _P, _P] + [_I] * 11
                         + [_P, ctypes.c_size_t, _P],
                         replaces="wiflow_tpu/ops/pallas/axial_attention.py:414")
_GROUP_CHANNELS = 8
_MAX_POSITIONS = 80           # positions a tile: v2 (and v1) launches
_DUAL_POSITIONS = 64          # positions a tile of the one-launch kernel
_MAX_LENGTH = 32
_MIN_THREADS = 128
_QUERIES = 2                  # queries a thread of the core
# a block's most threads (__launch_bounds__(n, 2)): the v2 kernel's
# (axial_attention_eval.cuh: kMaxAttnThreads) and the dual kernel's
_MAX_THREADS = 320
_DUAL_MAX_THREADS = 256
_SM_SMEM = 233472             # shared memory of an SM (228 KB)
_BLOCK_RESERVED = 1024        # of it held back for each resident block


class AxisWeights(NamedTuple):
    """One attention axis, BNs folded."""

    wq: torch.Tensor     # [C, 3C] compute dtype (bn_qkv folded)
    bq: torch.Tensor     # [3C] fp32
    sim: torch.Tensor    # [2, G] fp32: bn_similarity (scale, bias)
    oaff: torch.Tensor   # [2, C] fp32: bn_output (scale, bias)
    wpack: Optional[torch.Tensor] = None   # the kernels' packing of wq
    #                      (axis_weights): bf16 in tensor-core B-fragment
    #                      order, fp32 [C, 3C] flat; None where C is not a
    #                      multiple of 16


def axis_weights(aw: AxisWeights) -> AxisWeights:
    """``aw`` with ``wpack``, the kernels' packing of ``wq``: bf16 in the
    order ``mma.sync`` reads its B fragments (``fragments.py``), fp32 as
    it lies; None for widths the kernels do not take (C not a multiple of
    16), which the plain version still serves."""
    c = aw.wq.shape[0]
    if c % 16:
        return aw._replace(wpack=None)
    if aw.wq.dtype == torch.bfloat16:
        return aw._replace(wpack=to_fragments(aw.wq).contiguous())
    return aw._replace(wpack=aw.wq.reshape(-1))


def pack_axial_attention(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "attention", *, dtype: torch.dtype,
                         device: torch.device
                         ) -> Tuple[AxisWeights, AxisWeights]:
    """Fold the BNs of ``{prefix}.width_axis`` / ``.height_axis`` and pack
    ``wq`` for the kernels, once."""
    axes = []
    for axis in ("width_axis", "height_axis"):
        p = f"{prefix}.{axis}"
        sc, bi = folded_bn(state_dict, f"{p}.bn_qkv")
        w = state_dict[f"{p}.qkv_transform.weight"].float()[:, :, 0]  # [3C, C]
        wq = (w * sc[:, None]).t()
        sim = torch.stack(folded_bn(state_dict, f"{p}.bn_similarity"))
        oaff = torch.stack(folded_bn(state_dict, f"{p}.bn_output"))
        f32 = dict(device=device, dtype=torch.float32)
        axes.append(axis_weights(AxisWeights(
            wq.to(device=device, dtype=dtype).contiguous(),
            bi.to(**f32).contiguous(), sim.to(**f32).contiguous(),
            oaff.to(**f32).contiguous())))
    return axes[0], axes[1]


def _core_plain(qkv: torch.Tensor, sim: torch.Tensor, oaff: torch.Tensor,
                width: bool, dtype: torch.dtype) -> torch.Tensor:
    """Logits, bn_similarity, softmax, weighted sum and bn_output in fp32
    on ``qkv [B, H, W, 3C]`` along W or H; ``[B, H, W, C]`` in ``dtype``."""
    b, h, w, c3 = qkv.shape
    c, g = c3 // 3, sim.shape[1]
    qr = qkv if width else qkv.transpose(1, 2)
    n, length = (b * h, w) if width else (b * w, h)
    q, k, v = (t.reshape(n, length, g, c // g)
               for t in torch.split(qr.float(), c, dim=-1))
    lg = torch.einsum("nigc,njgc->ngij", q, k)
    lg = lg * sim[0][None, :, None, None] + sim[1][None, :, None, None]
    p = torch.softmax(lg, dim=-1)
    o = torch.einsum("ngij,njgc->nigc", p, v).reshape(n, length, c)
    out = (o * oaff[0] + oaff[1]).to(dtype)
    if width:
        return out.reshape(b, h, w, c)
    return out.reshape(b, w, h, c).transpose(1, 2).contiguous()


def axial_attention_plain(x: torch.Tensor, aw: AxisWeights,
                          width: bool) -> torch.Tensor:
    """Stock-torch version of one kernel launch on ``[B, H, W, C]``."""
    qkv = x.float() @ aw.wq.float() + aw.bq
    return _core_plain(qkv, aw.sim, aw.oaff, width, x.dtype)


def _check_affines(sim: torch.Tensor, oaff: torch.Tensor, c: int,
                   dev: torch.device) -> int:
    """Check one axis's bn_similarity and bn_output affines; its groups."""
    g = sim.shape[1]
    check_tensor(sim, "sim", device=dev, dtype=torch.float32, shape=(2, g))
    check_tensor(oaff, "oaff", device=dev, dtype=torch.float32, shape=(2, c))
    if c != g * _GROUP_CHANNELS:
        raise ValueError(f"the kernel takes {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={g}")
    return g


def _check_axis(aw: AxisWeights, c: int, dev: torch.device,
                dt: torch.dtype) -> int:
    """Check one axis's folded and packed weights for a kernel that
    projects; its groups."""
    check_tensor(aw.bq, "bq", device=dev, dtype=torch.float32,
                 shape=(3 * c,))
    if aw.wpack is None:
        raise ValueError("the kernel reads the packed wq: pack the weights "
                         "with pack_axial_attention or axis_weights (C must "
                         f"be a multiple of 16, got {c})")
    check_tensor(aw.wpack, "wpack", device=dev, dtype=dt,
                 shape=(3 * c * c,))
    return _check_affines(aw.sim, aw.oaff, c, dev)


# -- the launch plan ----------------------------------------------------------

def _qkv_row(c: int) -> int:
    """Bytes of a position's fp32 q, k, v in shared memory
    (``axial_attention_eval.cuh``: ``qkv_ld``)."""
    return (3 * c + 24) * 4


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _row_elems(n: int, esize: int) -> int:
    """``n`` elements or more, a whole and odd number of 16-byte words: rows
    that far apart put the 8 rows of an ldmatrix (or the 8 positions of a
    warp's fp32 loads) in 8 different bank groups."""
    words = -(-n * esize // 16)
    return (words + 1 - words % 2) * 16 // esize


def _core_threads(seqs: int, length: int, groups: int, most: int) -> int:
    """Threads for the core's items of a tile (``_QUERIES`` queries of one
    group each), whole warps, from 128 to ``most``; a tile with more items
    takes them in turns."""
    items = seqs * -(-length // _QUERIES) * groups
    return max(_MIN_THREADS, min(most, -(-items // 32) * 32))


def _blocks_per_sm(smem: int, threads: int, most: int) -> int:
    """Blocks that fit an SM's shared memory and, with the registers that
    launch bounds of ``most`` threads and two blocks allow a thread, its
    65,536 registers."""
    regs = 65536 // (2 * most)
    return min(_SM_SMEM // (smem + _BLOCK_RESERVED), 65536 // (regs * threads))


class AxisPlan(NamedTuple):
    """One launch of ``csrc/axial_attention.cu`` along one axis."""

    length: int          # L: positions a sequence
    seqs: int            # whole sequences a tile
    threads: int         # a block's threads
    ldx: int             # elements of a staged input row
    smem: int            # bytes of shared memory a block
    layout: Tuple[int, int, int, int]   # bytes: weights, zero row, staged
    #                      rows, fp32 q, k, v
    blocks_per_sm: int
    tiles: int
    grid: int            # persistent: at most blocks_per_sm x SMs


class DualPlan(NamedTuple):
    """The launch of ``csrc/axial_attention_dual.cu``."""

    rows: int            # whole rows of W positions a pass-1 tile
    cols: int            # whole columns of H positions a pass-2 tile
    threads: int
    lda: int             # elements between positions of the intermediate
    rstride: int         # elements between its rows of W positions
    smem: int            # bytes of shared memory a block
    layout: Tuple[int, int, int, int]   # bytes: one axis's weights, zero
    #                      row, intermediate (which takes the staged input
    #                      rows too), fp32 q, k, v
    blocks_per_sm: int   # 0: a sample does not fit one block
    grid: int


class AttentionPlan(NamedTuple):
    width: AxisPlan      # v2 along W
    height: AxisPlan     # v2 along H
    dual: DualPlan       # both axes in one launch


@functools.lru_cache(maxsize=None)
def attention_plan(batch: int, h: int, w: int, c: int, groups: int,
                   dtype: torch.dtype, sms: int = SMS) -> AttentionPlan:
    """The launches for ``[batch, h, w, c]`` with ``groups`` groups of 8
    channels.  Pure: the CPU tests hold it.

    A tile is whole sequences, at most 80 positions (v2) or 64 (the
    one-launch kernel, which also holds the sample's intermediate).  A
    block's threads cover the core's items of a tile; its shared memory
    holds the resident bf16 weights (one axis), a zero row, the tile's
    staged input rows and its fp32 q, k, v; the grid is the blocks that fit
    the SMs at once, walking the tiles."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    if c != groups * _GROUP_CHANNELS:
        raise ValueError(f"the kernels take {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={groups}")
    if c % 16:
        raise ValueError(f"the kernels take C a multiple of 16 (the "
                         f"tensor cores' depth), got C={c}")
    if max(h, w) > _MAX_LENGTH:
        raise ValueError(f"sequence length {max(h, w)} > {_MAX_LENGTH}")
    esize = 2 if dtype == torch.bfloat16 else 4
    wbytes = _align16(3 * c * c * 2) if esize == 2 else 0
    ldx = _row_elems(c, esize)
    qkv_row = _qkv_row(c)
    axes = []
    for length, nseq in ((w, batch * h), (h, batch * w)):
        seqs = max(1, _MAX_POSITIONS // length)
        npos = seqs * length
        layout = (wbytes, _align16(ldx * esize), _align16(npos * ldx * esize),
                  npos * qkv_row)
        smem = sum(layout)
        if smem > SMEM_LIMIT:
            raise ValueError(f"a tile of {npos} positions needs {smem} bytes "
                             f"of shared memory, more than {SMEM_LIMIT}")
        threads = _core_threads(seqs, length, groups, _MAX_THREADS)
        bps = _blocks_per_sm(smem, threads, _MAX_THREADS)
        tiles = -(-nseq // seqs)
        axes.append(AxisPlan(length, seqs, threads, ldx, smem, layout, bps,
                             tiles, max(1, min(tiles, bps * sms))))
    rows = max(1, min(h, _DUAL_POSITIONS // w))
    cols = max(1, min(w, _DUAL_POSITIONS // h))
    if esize == 2:   # positions C apart, 16-byte chunks swizzled
        lda, rstride = c, w * c
    else:
        lda = ldx
        rstride = _row_elems(w * lda, esize)
    layout = (wbytes, _align16(c * esize), _align16(h * rstride * esize),
              max(rows * w, cols * h) * qkv_row)
    smem = sum(layout)
    most = _DUAL_MAX_THREADS
    threads = max(_core_threads(rows, w, groups, most),
                  _core_threads(cols, h, groups, most))
    bps = _blocks_per_sm(smem, threads, most) if smem <= SMEM_LIMIT else 0
    dual = DualPlan(rows, cols, threads, lda, rstride, smem, layout, bps,
                    min(batch, bps * sms))
    return AttentionPlan(axes[0], axes[1], dual)


class V1AxisPlan(NamedTuple):
    """One launch of ``csrc/axial_attention_v1.cu`` along one axis."""

    length: int          # L: positions a sequence
    seqs: int            # whole sequences a tile
    threads: int         # a block's threads
    smem: int            # bytes of shared memory a block
    layout: Tuple[int, int, int]   # bytes: the fp32 q, k, v tile; the raw
    #                      tile (the next tile's rows in the storage type,
    #                      in flight while the core runs); its mbarrier
    blocks_per_sm: int
    tiles: int
    grid: int            # persistent: at most blocks_per_sm x SMs


class V1Plan(NamedTuple):
    width: V1AxisPlan
    height: V1AxisPlan


@functools.lru_cache(maxsize=None)
def v1_plan(batch: int, h: int, w: int, c: int, groups: int,
            dtype: torch.dtype, sms: int = SMS) -> V1Plan:
    """The v1 launches on a ``qkv [batch, h, w, 3c]`` with ``groups``
    groups of 8 channels.  Pure: the CPU tests hold it.

    A tile is whole sequences, at most 80 positions (fewer where a wide C
    would not fit); a block's threads cover the core's items of a tile (2
    queries of one group each).  Its shared memory holds one fp32 q, k, v
    tile in the core's layout and one raw tile (``[npos, 3C]`` in
    ``dtype``) with its mbarrier.  The grid is the blocks that fit the SMs
    at once, walking the tiles."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    if c != groups * _GROUP_CHANNELS:
        raise ValueError(f"the kernel takes {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={groups}")
    if max(h, w) > _MAX_LENGTH:
        raise ValueError(f"sequence length {max(h, w)} > {_MAX_LENGTH}")
    esize = 2 if dtype == torch.bfloat16 else 4
    axes = []
    for length, nseq in ((w, batch * h), (h, batch * w)):

        def fit(seqs):
            npos = seqs * length
            threads = _core_threads(seqs, length, groups, _MAX_THREADS)
            layout = (npos * _qkv_row(c), npos * 3 * c * esize, 8)
            smem = sum(layout)
            bps = (_blocks_per_sm(smem, threads, _MAX_THREADS)
                   if smem <= SMEM_LIMIT else 0)
            return threads, layout, smem, bps

        seqs = max(1, _MAX_POSITIONS // length)
        while seqs > 1 and fit(seqs)[3] < 1:
            seqs -= 1
        threads, layout, smem, bps = fit(seqs)
        if bps < 1:
            raise ValueError(f"a tile of {seqs * length} positions needs "
                             f"{smem} bytes of shared memory, more than "
                             f"{SMEM_LIMIT}")
        tiles = -(-nseq // seqs)
        axes.append(V1AxisPlan(length, seqs, threads, smem, layout, bps,
                               tiles, max(1, min(tiles, bps * sms))))
    return V1Plan(axes[0], axes[1])


def _launch(x: torch.Tensor, aw: AxisWeights, width: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    check_tensor(x, "x", device=dev, dtype=dt)
    g = _check_axis(aw, c, dev, dt)
    plan = attention_plan(b, h, w, c, g, dt, sm_count(dev.index or 0))
    ap = plan.width if width else plan.height
    if width:      # sequences (b, h) along W
        n_inner, inner, seq = h, w * c, c
    else:          # sequences (b, w) along H, read as strided columns
        n_inner, inner, seq = w, c, w * c
    out = torch.empty_like(x)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), b * n_inner, ap.length,
                  c, g, n_inner, inner, h * w * c, seq, ap.seqs, ap.threads,
                  ap.grid, ap.ldx, ptr(aw.wpack), ptr(aw.bq), ptr(aw.sim),
                  ptr(aw.oaff), ctypes.c_size_t(ap.smem), stream_ptr(dev))
    return out


def axial_attention(x: torch.Tensor, aw: AxisWeights,
                    width: bool) -> torch.Tensor:
    """Eval attention along W (``width=True``) or H of ``[B, H, W, C]``.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`axial_attention_plain`.
    """
    if x.device.type == "cuda":
        return _launch(x, aw, width)
    if x.device.type == "cpu":
        return axial_attention_plain(x, aw, width)
    raise ValueError(f"axial_attention runs on cuda or cpu tensors, not "
                     f"{x.device}")


def dual_axial_attention_eval(x: torch.Tensor,
                              axes: Tuple[AxisWeights, AxisWeights]
                              ) -> torch.Tensor:
    """Width-axis then height-axis attention on ``[B, H, W, C]``; two
    kernel launches on the card.  Output in standard channel order."""
    return axial_attention(axial_attention(x, axes[0], True), axes[1], False)


# -- both axes in one launch (``attention_impl="dual"``) ---------------------

def dual_axial_attention_fused_plain(x: torch.Tensor,
                                     axes: Tuple[AxisWeights, AxisWeights]
                                     ) -> torch.Tensor:
    """Stock-torch version of the one-launch kernel: the width axis's
    output is rounded to ``x.dtype`` between the axes, as the kernel rounds
    its on-chip intermediate."""
    return axial_attention_plain(axial_attention_plain(x, axes[0], True),
                                 axes[1], False)


def _launch_dual(x: torch.Tensor, axes: Tuple[AxisWeights, AxisWeights]
                 ) -> torch.Tensor:
    b, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    check_tensor(x, "x", device=dev, dtype=dt)
    g = _check_axis(axes[0], c, dev, dt)
    if _check_axis(axes[1], c, dev, dt) != g:
        raise ValueError("the two axes have different group counts")
    dp = attention_plan(b, h, w, c, g, dt, sm_count(dev.index or 0)).dual
    if dp.blocks_per_sm < 1:
        raise ValueError(
            f"a [{h}, {w}, {c}] {dt} sample needs {dp.smem} bytes of shared "
            f"memory in one thread block ({dp.layout[2]} of them its "
            f"intermediate), more than the {SMEM_LIMIT} a block may use; "
            f"attention_impl='v2' has no such limit")
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for aw in axes
            for t in (aw.wpack, aw.bq, aw.sim, aw.oaff)]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    KERNEL_DUAL.launch(dtype_code(dt), ptr(x), ptr(out), b, h, w, c, g,
                       dp.rows, dp.cols, dp.threads, dp.grid, dp.lda,
                       dp.rstride, c_ptrs, ctypes.c_size_t(dp.smem),
                       stream_ptr(dev))
    return out


def dual_axial_attention_eval_fused(x: torch.Tensor,
                                    axes: Tuple[AxisWeights, AxisWeights]
                                    ) -> torch.Tensor:
    """Width-axis then height-axis attention on ``[B, H, W, C]`` in one
    kernel launch on the card; the intermediate between the axes stays in
    shared memory.  A CUDA tensor goes through the kernel (or raises: a
    sample that does not fit a thread block is refused, never split into
    two launches); a CPU tensor through
    :func:`dual_axial_attention_fused_plain`."""
    if x.device.type == "cuda":
        return _launch_dual(x, axes)
    if x.device.type == "cpu":
        return dual_axial_attention_fused_plain(x, axes)
    raise ValueError(f"dual_axial_attention_eval_fused runs on cuda or cpu "
                     f"tensors, not {x.device}")


# -- v1: the projection outside the kernel (``attention_impl="v1"``) ---------

def project_qkv_v1(x: torch.Tensor, aw: AxisWeights) -> torch.Tensor:
    """``x [..., C] @ Wq + bq`` with fp32 accumulation, rounded once to
    ``x.dtype``: the v1 path's projection, a stock matrix product as in the
    JAX package.  The bias enters in ``x.dtype``."""
    c = x.shape[-1]
    qkv = torch.addmm(aw.bq.to(x.dtype), x.reshape(-1, c), aw.wq)
    return qkv.reshape(*x.shape[:-1], 3 * c)


def _as_4d(qkv: torch.Tensor) -> torch.Tensor:
    if qkv.ndim == 3:              # [N, L, 3C]: N sequences along the width
        return qkv[:, None]
    if qkv.ndim == 4:
        return qkv
    raise ValueError(f"qkv is [N, L, 3C] or [B, H, W, 3C], got "
                     f"{tuple(qkv.shape)}")


def axial_attention_v1_plain(qkv: torch.Tensor, sim: torch.Tensor,
                             oaff: torch.Tensor,
                             width: bool = True) -> torch.Tensor:
    """Stock-torch version of the v1 kernel on a precomputed ``qkv``."""
    out = _core_plain(_as_4d(qkv), sim, oaff, width, qkv.dtype)
    return out[:, 0] if qkv.ndim == 3 else out


def _launch_v1(qkv: torch.Tensor, sim: torch.Tensor, oaff: torch.Tensor,
               width: bool) -> torch.Tensor:
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    dev, dt = qkv.device, qkv.dtype
    check_tensor(qkv, "qkv", device=dev, dtype=dt, shape=(b, h, w, 3 * c))
    g = _check_affines(sim, oaff, c, dev)
    plan = v1_plan(b, h, w, c, g, dt, sm_count(dev.index or 0))
    ap = plan.width if width else plan.height
    # strides in positions: the kernel scales them by 3C (qkv) and C (out)
    if width:      # sequences (b, h) along W
        n_inner, inner, seq = h, w, 1
    else:          # sequences (b, w) along H, read as strided columns
        n_inner, inner, seq = w, 1, w
    out = torch.empty((b, h, w, c), dtype=dt, device=dev)
    KERNEL_V1.launch(dtype_code(dt), ptr(qkv), ptr(out), b * n_inner,
                     ap.length, c, g, n_inner, inner, h * w, seq, ap.seqs,
                     ap.threads, ap.grid, ptr(sim), ptr(oaff),
                     ctypes.c_size_t(ap.smem), stream_ptr(dev))
    return out


def axial_attention_v1(qkv: torch.Tensor, sim: torch.Tensor,
                       oaff: torch.Tensor, width: bool = True) -> torch.Tensor:
    """The v1 attention core on a precomputed projection: ``qkv
    [N, L, 3C]`` -> ``[N, L, C]``, or ``[B, H, W, 3C]`` -> ``[B, H, W, C]``
    along W (``width=True``) or H, in ``qkv.dtype``.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`axial_attention_v1_plain`.
    """
    if qkv.device.type == "cuda":
        out = _launch_v1(_as_4d(qkv), sim, oaff, width)
        return out[:, 0] if qkv.ndim == 3 else out
    if qkv.device.type == "cpu":
        return axial_attention_v1_plain(qkv, sim, oaff, width)
    raise ValueError(f"axial_attention_v1 runs on cuda or cpu tensors, not "
                     f"{qkv.device}")


def dual_axial_attention_eval_v1(x: torch.Tensor,
                                 axes: Tuple[AxisWeights, AxisWeights]
                                 ) -> torch.Tensor:
    """Width-axis then height-axis v1 attention on ``[B, H, W, C]``: per
    axis one stock matrix product and one kernel launch.  The height axis
    is projected on the ``[B, H, W, C]`` tensor as it lies and the kernel
    reads and writes its columns through a sequence stride, so neither
    axis transposes anything in device memory."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dual_axial_attention_eval_v1 runs on cuda or cpu "
                         f"tensors, not {x.device}")
    for aw, width in zip(axes, (True, False)):
        x = axial_attention_v1(project_qkv_v1(x, aw), aw.sim, aw.oaff, width)
    return x
