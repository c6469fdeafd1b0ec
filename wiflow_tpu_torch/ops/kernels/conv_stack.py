"""Fused eval conv stack: CUDA kernel, its plain version, and the packer.

Counterpart of ``wiflow_tpu/ops/pallas/conv_stack.py``
(``fused_conv_stack_eval``, ``pack_conv_stack``).  Rows ``[R, W0]`` (one
per sample and time step) go through ConvBlock1 and the stride-2 blocks
to ``[R, C_last, W_last]``.  Per block, BN folded:

    h1  = silu(conv1x3(x, stride) + b1)                  -> rounded
    h2  = silu(conv1x3(h1) + b2)                         -> rounded
    out = silu(conv1x3(h2) + b3 + x[:, ::stride] @ D + e) -> rounded

A (1,3) conv with padding 1 reads ``x[stride*w + d - 1]``.  On a CUDA
tensor :func:`fused_conv_stack_eval` launches ``csrc/conv_stack.cu`` once
for the whole stack; on a CPU tensor it runs :func:`conv_stack_plain`.
The TPU kernel's space-to-depth banded weights are not carried over: the
blocks keep the plain ``[3, C_in, C_out]`` taps, and :func:`stack_weights`
packs them once more for the kernel, each conv as the ``[K, C_out]``
matrix of its implicit GEMM (K = 8-channel chunks, tap-major, then the
shortcut's), in bf16 in the order the tensor cores' B fragments are read.
:func:`conv_stack_plan` sizes the launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections.abc import Sequence as SequenceABC
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, SMS, CudaKernel, check_tensor, dtype_code, ptr, sm_count,
    stream_ptr,
)
from wiflow_tpu_torch.ops.kernels.fragments import to_fragments
from wiflow_tpu_torch.ops.norm import folded_bn

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("conv_stack", "conv_stack_forward",
                    [_I, _P, _P] + [_I] * 6 + [_P, _P, _P, _I, _I,
                                               ctypes.c_size_t, _P],
                    replaces="wiflow_tpu/ops/pallas/conv_stack.py:218")
_MAX_BLOCKS = 8
THREADS = 768                 # 24 warps, one block an SM
_WARPS = THREADS // 32
_MAX_NT = 4                   # 8-column tiles of a warp unit
_ZERO_BYTES = 512             # the kernel's row of zeros
_MAX_TILE_ROWS = 32


class ConvBlockWeights(NamedTuple):
    """One block, BN folded.  Weights in the compute dtype, biases fp32."""

    w1: torch.Tensor     # [3, C_in, C_out]
    b1: torch.Tensor     # [C_out]
    w2: torch.Tensor     # [3, C_out, C_out]
    b2: torch.Tensor
    w3: torch.Tensor     # [3, C_out, C_out]
    b3: torch.Tensor
    wd: torch.Tensor     # [C_in, C_out] strided 1x1 shortcut
    bd: torch.Tensor
    stride: int


def pack_conv_stack(state_dict: Mapping[str, torch.Tensor], n_blocks: int, *,
                    dtype: torch.dtype,
                    device: torch.device) -> "ConvStackWeights":
    """Fold the BNs of ``up`` and ``residual_blocks.{j}`` (torch layouts,
    reference names) into ``[3, C_in, C_out]`` taps, and pack those for
    the kernel, once."""
    blocks = []
    names = ["up"] + [f"residual_blocks.{j}" for j in range(n_blocks)]
    for k, p in enumerate(names):
        parts = []
        for conv, bn in ((0, 1), (4, 5), (8, 9)):
            sc, bi = folded_bn(state_dict, f"{p}.block.{bn}")
            w = state_dict[f"{p}.block.{conv}.weight"].float()[:, :, 0, :]
            w = (w * sc[:, None, None]).permute(2, 1, 0)   # [3, Ci, Co]
            b = sc * state_dict[f"{p}.block.{conv}.bias"].float() + bi
            parts += [w, b]
        sc, bi = folded_bn(state_dict, f"{p}.downsample.1")
        wd = state_dict[f"{p}.downsample.0.weight"].float()[:, :, 0, 0]
        parts += [(wd * sc[:, None]).t(), bi]
        parts = [t.to(device=device,
                      dtype=dtype if t.ndim > 1 else torch.float32
                      ).contiguous() for t in parts]
        blocks.append(ConvBlockWeights(*parts, stride=1 if k == 0 else 2))
    return stack_weights(blocks)


@dataclasses.dataclass(frozen=True, eq=False)
class ConvStackWeights(SequenceABC):
    """The blocks of a stack (a sequence of :class:`ConvBlockWeights`) and
    the kernel's packing of them."""

    blocks: Tuple[ConvBlockWeights, ...]
    wpack: Optional[torch.Tensor]   # bf16: B fragments, fp32: [K_pad, C_out],
    #                                 each conv; None where the kernel does
    #                                 not take the widths
    vec: Optional[torch.Tensor]     # fp32: biases (conv3's with the
    #                                 shortcut's), the taps of a 1-channel
    #                                 block's conv1 and shortcut

    def __getitem__(self, i):
        return self.blocks[i]

    def __len__(self):
        return len(self.blocks)


def _ld(c: int) -> int:
    """Elements of a position's row in shared memory: whole 16-byte words
    (8 channels; a 1-channel input is not read by ldmatrix), an odd number
    of them, so that an ldmatrix's 8 rows meet no bank conflict."""
    return 1 if c == 1 else (c if c // 8 % 2 else c + 8)


def _chans(blocks: Sequence[ConvBlockWeights]) -> Tuple[Tuple[int, int, int], ...]:
    return tuple((b.w1.shape[1], b.w1.shape[2], b.stride) for b in blocks)


class _ConvShape(NamedTuple):
    k: int        # rows of the GEMM's [K, C_out] weight (0: elementwise)
    ksteps: int   # 16-deep steps
    woff: int     # first element in the packed weights
    boff: int     # first float of its bias in the vectors


class _BlockShape(NamedTuple):
    ci: int
    co: int
    stride: int
    convs: Tuple[_ConvShape, _ConvShape, _ConvShape]
    w1off: int    # 1-channel block: taps [3, C_out], shortcut [C_out]; or -1
    wdoff: int


@functools.lru_cache(maxsize=None)
def _stack_shapes(chans: Tuple[Tuple[int, int, int], ...]
                  ) -> Tuple[Tuple[_BlockShape, ...], int, int]:
    """Per block the layout of its weights; the packed weight elements and
    the vector floats in all."""
    if not 1 <= len(chans) <= _MAX_BLOCKS:
        raise ValueError(f"1..{_MAX_BLOCKS} conv blocks, got {len(chans)}")
    shapes, woff, voff, cin = [], 0, 0, 1
    for k, (ci, co, stride) in enumerate(chans):
        if ci != cin:
            raise ValueError(f"block {k} takes {ci} channels, block {k - 1} "
                             f"gives {cin}")
        if co % 8 or (ci != 1 and ci % 8):
            raise ValueError(f"block {k}: {ci} -> {co} channels; the kernel "
                             f"takes 1 or a multiple of 8 in, a multiple of 8 "
                             f"out")
        ks = [3 * ci if ci > 1 else 0, 3 * co, 3 * co + (ci if ci > 1 else 0)]
        convs = []
        for j, kk in enumerate(ks):
            kpad = -(-kk // 16) * 16
            convs.append(_ConvShape(kk, kpad // 16, woff, voff + j * co))
            woff += kpad * co
        voff += 3 * co
        w1off = wdoff = -1
        if ci == 1:
            w1off, wdoff = voff, voff + 3 * co
            voff += 4 * co
        shapes.append(_BlockShape(ci, co, stride, tuple(convs), w1off,
                                  wdoff))
        cin = co
    return tuple(shapes), woff, voff


def _k_matrix(blk: ConvBlockWeights, j: int) -> torch.Tensor:
    """Conv j's GEMM weight ``[K, C_out]`` in fp32: rows tap-major, channel
    minor (``w.reshape(3 C_in, C_out)``), conv3 followed by the shortcut's
    ``C_in`` rows where ``C_in >= 8``."""
    w = (blk.w1, blk.w2, blk.w3)[j].float()
    m = w.reshape(-1, w.shape[-1])
    if j == 2 and blk.wd.shape[0] > 1:
        m = torch.cat([m, blk.wd.float()])
    return m


def stack_weights(blocks: Sequence[ConvBlockWeights]) -> ConvStackWeights:
    """Pack the blocks' taps for the kernel (see the module note)."""
    blocks = tuple(blocks)
    w1 = blocks[0].w1
    dt, dev = w1.dtype, w1.device
    try:
        shapes, nw, nv = _stack_shapes(_chans(blocks))
    except ValueError:
        # widths the kernel does not take: the plain version serves them,
        # and a launch raises with the reason
        return ConvStackWeights(blocks, None, None)
    wpack = torch.zeros(nw, dtype=torch.float32)
    vec = torch.zeros(nv, dtype=torch.float32)
    for blk, sh in zip(blocks, shapes):
        co = sh.co
        for j, cs in enumerate(sh.convs):
            bias = (blk.b1, blk.b2, blk.b3 + blk.bd)[j]
            vec[cs.boff:cs.boff + co] = bias.float().cpu()
            if cs.k == 0:
                continue
            m = torch.zeros(cs.ksteps * 16, co)
            m[:cs.k] = _k_matrix(blk, j).cpu()
            if dt == torch.bfloat16:
                m = to_fragments(m)
            wpack[cs.woff:cs.woff + m.numel()] = m.reshape(-1)
        if sh.w1off >= 0:
            vec[sh.w1off:sh.w1off + 3 * co] = blk.w1.float().reshape(-1).cpu()
            vec[sh.wdoff:sh.wdoff + co] = blk.wd.float().reshape(-1).cpu()
    return ConvStackWeights(blocks, wpack.to(device=dev, dtype=dt),
                            vec.to(dev))


def _conv1x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int) -> torch.Tensor:
    """fp32 (1,3) conv, pad 1: ``x [R, Ci, W]``, ``w [3, Ci, Co]``."""
    wout = (x.shape[-1] - 1) // stride + 1
    xp = F.pad(x.float(), (1, 1))
    acc = b[None, :, None]
    for d in range(3):
        seg = xp[:, :, d:d + stride * (wout - 1) + 1:stride]
        acc = acc + torch.einsum("riw,io->row", seg, w[d].float())
    return acc


def conv_stack_plain(x: torch.Tensor,
                     blocks: Sequence[ConvBlockWeights]) -> torch.Tensor:
    """Stock-torch version of the kernel: same arithmetic, same roundings."""
    dt, silu = x.dtype, F.silu
    h = x[:, None, :]                                         # [R, 1, W0]
    for blk in blocks:
        h1 = silu(_conv1x3_plain(h, blk.w1, blk.b1, blk.stride)).to(dt)
        h2 = silu(_conv1x3_plain(h1, blk.w2, blk.b2, 1)).to(dt)
        y = _conv1x3_plain(h2, blk.w3, blk.b3, 1)
        ident = torch.einsum("riw,io->row", h[:, :, ::blk.stride].float(),
                             blk.wd.float()) + blk.bd[None, :, None]
        h = silu(y + ident).to(dt)
    return h


class ConvStackPlan(NamedTuple):
    """One launch of the kernel: what ``csrc/conv_stack.cu`` is given."""

    tile_rows: int          # rows a tile; a block walks tiles grid apart
    row_elems: int          # elements of a row in each of the three slots
    grid: int               # blocks: one an SM, at most one a tile
    blocks_per_sm: int
    smem: int               # bytes of shared memory a block
    nvec: int               # floats of the vectors
    wfrag: int              # bf16 weight elements staged (0 in fp32)
    lds: Tuple[int, ...]    # the row length of each block's output
    widths: Tuple[int, ...]  # each block's output width
    units: Tuple[Tuple[Tuple[int, int], ...], ...]   # (m-, n-tiles) of a
    #                         warp unit, per block and conv
    dims: Tuple[int, ...]   # the C side's 24 ints a block


# Warp units the kernel has (m-tiles, n-tiles): at most 4 accumulator tiles.
UNIT_SHAPES = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (4, 1))


def _unit_shape(mtiles: int, ntot: int, ksteps: int) -> Tuple[int, int]:
    """The warp unit of one conv: the fewest issue slots over the 24 warps'
    rounds, a unit costed in instructions (about 40 fixed, per k-step 8 an
    m-tile for its address and A fragment, 2 an n-tile for its B fragment
    and 1 a product, 12 a tile for the epilogue); ties go to the larger
    unit."""
    best = None
    for mtu, nt in UNIT_SHAPES:
        if ntot % nt:
            continue
        units = -(-mtiles // mtu) * (ntot // nt)
        cost = -(-units // _WARPS) * (
            40 + ksteps * (8 * mtu + 2 * nt + mtu * nt) + 12 * mtu * nt)
        if best is None or cost < best[0] or (
                cost == best[0] and mtu * nt > best[1][0] * best[1][1]):
            best = (cost, (mtu, nt))
    return best[1]


@functools.lru_cache(maxsize=None)
def conv_stack_plan(rows: int, w0: int,
                    chans: Tuple[Tuple[int, int, int], ...],
                    dtype: torch.dtype, sms: int = SMS) -> ConvStackPlan:
    """The launch for ``rows`` rows of ``w0`` features through blocks of
    ``chans`` = ((C_in, C_out, stride), ...).  Pure: the CPU tests hold it.

    bf16 stages every weight in shared memory for the block's life, fp32
    reads them from device memory; the rest of an SM's shared memory holds
    the tile's three activation slots."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv stack takes float32 or bfloat16, got {dtype}")
    esize = 2 if dtype == torch.bfloat16 else 4
    shapes, nw, nvec = _stack_shapes(chans)
    wfrag = nw if esize == 2 else 0
    widths, lds, w = [], [], w0
    for sh in shapes:
        w = (w - 1) // sh.stride + 1
        widths.append(w)
        lds.append(_ld(sh.co))
    row_elems = -(-max([w0] + [a * b for a, b in zip(widths, lds)]) // 8) * 8
    fixed = -(-nvec * 4 // 16) * 16 + -(-wfrag * 2 // 16) * 16 + _ZERO_BYTES
    per_row = 3 * row_elems * esize
    fit = (SMEM_LIMIT - fixed) // per_row
    if fit < 1:
        raise ValueError(f"one row needs {fixed + per_row} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT} of a block")
    tile_rows = max(1, min(fit, _MAX_TILE_ROWS, rows))
    ntiles = -(-rows // tile_rows)
    units, dims, win, ld_in = [], [], w0, 1
    for sh, wout, ld in zip(shapes, widths, lds):
        mtiles = -(-tile_rows * wout // 16)
        dims += [sh.ci, sh.co, sh.stride, win, wout, ld_in, ld]
        shapes_k = []
        for cs in sh.convs:
            mtu, nt = _unit_shape(mtiles, sh.co // 8, cs.ksteps)
            shapes_k.append((mtu, nt))
            dims += [cs.ksteps, mtu, nt, cs.woff, cs.boff]
        units.append(tuple(shapes_k))
        dims += [sh.w1off, sh.wdoff]
        win, ld_in = wout, ld
    return ConvStackPlan(tile_rows, row_elems, min(ntiles, sms), 1,
                         fixed + tile_rows * per_row, nvec, wfrag,
                         tuple(lds), tuple(widths), tuple(units), tuple(dims))


def _launch(x: torch.Tensor, stack: ConvStackWeights) -> torch.Tensor:
    if not isinstance(stack, ConvStackWeights):
        raise TypeError("the kernel takes the packed ConvStackWeights "
                        "(pack_conv_stack, stack_weights), not bare blocks")
    rows, w0 = x.shape
    dev, dt = x.device, x.dtype
    check_tensor(x, "x", device=dev, dtype=dt)
    if stack.wpack is None:
        _stack_shapes(_chans(stack.blocks))   # raises with the reason
    check_tensor(stack.wpack, "wpack", device=dev, dtype=dt)
    check_tensor(stack.vec, "vec", device=dev, dtype=torch.float32)
    plan = conv_stack_plan(rows, w0, _chans(stack.blocks), dt,
                           sm_count(dev.index or 0))
    if stack.vec.numel() != plan.nvec:
        raise ValueError("the packed vectors do not match the blocks")
    co = stack.blocks[-1].w1.shape[2]
    out = torch.empty((rows, co, plan.widths[-1]), dtype=dt, device=dev)
    dims = (ctypes.c_int * len(plan.dims))(*plan.dims)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), rows, w0, plan.tile_rows,
                  plan.row_elems, plan.grid, len(stack.blocks), dims,
                  ptr(stack.wpack), ptr(stack.vec), plan.nvec, plan.wfrag,
                  ctypes.c_size_t(plan.smem), stream_ptr(dev))
    return out


def fused_conv_stack_eval(x: torch.Tensor,
                          blocks: ConvStackWeights) -> torch.Tensor:
    """The folded conv stack on rows ``[R, W0]`` -> ``[R, C_last, W_last]``.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`conv_stack_plain`.
    """
    if x.device.type == "cuda":
        return _launch(x, blocks)
    if x.device.type == "cpu":
        return conv_stack_plain(x, blocks)
    raise ValueError(f"fused_conv_stack_eval runs on cuda or cpu tensors, "
                     f"not {x.device}")
