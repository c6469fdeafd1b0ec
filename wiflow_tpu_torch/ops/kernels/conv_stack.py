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
packs them once more for the kernel, by the path :func:`conv_stack_plan`
takes for the dtype:

- bf16, the ``wgmma`` path: each conv with C_in >= 8 is an implicit GEMM
  whose k-steps are pairs of 8-channel views (:func:`wgmma_steps`: two
  channel chunks of one tap, two taps of one chunk, a shortcut chunk, or a
  chunk beside zero weights); its ``[16 ks, C_out]`` matrix in wgmma's B
  order (``fragments.py::to_wgmma_b``).  The plan lays each warpgroup's
  activations out position-major in 16-byte atoms, every row padded with
  a zero position at both ends and a stride-2 block's input in even and
  odd planes, so that each view is a shared-memory descriptor: the plan's
  table of k-steps (byte offset, leading byte offset) is all the kernel
  reads to address them;
- fp32, the ``fma`` path on CUDA cores: each conv as the ``[K, C_out]``
  matrix of its implicit GEMM (K = 8-channel chunks, tap-major, then the
  shortcut's), K padded to 16.

A launch on the wgmma path counts its convolutions on wgmma in
:data:`wgmma_convs` and ``serve.conv_stack_wgmma_convs``
(``utils/trace.py``, while tracing is on).
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
from wiflow_tpu_torch.ops.kernels.fragments import to_wgmma_b
from wiflow_tpu_torch.ops.norm import folded_bn
from wiflow_tpu_torch.utils import trace

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("conv_stack", "conv_stack_forward",
                    [_I, _P, _P] + [_I] * 6 + [_P, _P, _P, _I, _I,
                                               ctypes.c_size_t, _P],
                    replaces="wiflow_tpu/ops/pallas/conv_stack.py:218")
_MAX_BLOCKS = 8
THREADS = 768                 # fp32: 24 warps, one block an SM
_WARPS = THREADS // 32
_MAX_NT = 4                   # 8-column tiles of a warp unit
_ZERO_BYTES = 512             # the kernel's row of zeros
_MAX_TILE_ROWS = 32
# bf16 (wgmma): warpgroups a block (each walks its own row tiles), the
# widest C_out (one m64nNk16 per k-step, N = 8 NT, NT <= 8), the plan's
# table sizes, and the ints a conv takes in the kernel's arguments
_MAX_WGS = 5
_WG_ROWS = 3                  # the tile rows the warpgroup count is set by
_MAX_W_NT = 8
_MAX_KSTEPS = 160
_CONV_INTS = 16
_M = 64                       # wgmma's M: positions of an m-tile
_SLACK = (_M + 4) * 16        # bytes after the regions that views may read

# Convolutions launched on wgmma (bf16), a plain integer beside
# ``KERNEL.launches``; callers may reset it to 0.
wgmma_convs = 0


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
    wpack: Optional[torch.Tensor]   # bf16: wgmma B k-steps, fp32: [K_pad,
    #                                 C_out], each conv; None where the
    #                                 kernel does not take the widths
    vec: Optional[torch.Tensor]     # fp32: biases (conv3's with the
    #                                 shortcut's), the taps of a 1-channel
    #                                 block's conv1 and shortcut

    def __getitem__(self, i):
        return self.blocks[i]

    def __len__(self):
        return len(self.blocks)


def _ld(c: int) -> int:
    """Elements of a position's row in shared memory (fp32): whole 16-byte
    words of 8 channels (a 1-channel input is read one element at a time),
    an odd number of them, so that the 8 positions a warp's lanes read at
    once meet no bank conflict."""
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


# A view: 8 channels of the A operand for every output position.
# ("tap", d, c): tap d of the conv's source, channel chunk c;
# ("short", c): the strided shortcut's chunk c of the block's input;
# None: zero weights (the k-step's other half is read, times zero).
View = Optional[Tuple]


@functools.lru_cache(maxsize=None)
def wgmma_steps(chans: Tuple[Tuple[int, int, int], ...]
                ) -> Tuple[Tuple[Tuple[Tuple[View, View], ...], ...], ...]:
    """Per block, per conv, the k-steps of its wgmma GEMM as pairs of
    views (K rows 0-7 and 8-15 of the step); empty for ConvBlock1's
    elementwise first conv.  Two chunks of one tap where the source has an
    even number of chunks; an odd one left over pairs tap 0 with tap 1 and
    tap 2 with zeros; the shortcut's chunks follow conv3's taps."""
    out = []
    for ci, co, _ in chans:
        convs = []
        for j in range(3):
            steps = []
            if j == 0 and ci == 1:
                convs.append(())
                continue
            cc = (ci if j == 0 else co) // 8
            for d in range(3):
                steps += [(("tap", d, 2 * i), ("tap", d, 2 * i + 1))
                          for i in range(cc // 2)]
            if cc % 2:
                steps += [(("tap", 0, cc - 1), ("tap", 1, cc - 1)),
                          (("tap", 2, cc - 1), None)]
            if j == 2 and ci > 1:
                cs = ci // 8
                steps += [(("short", 2 * i), ("short", 2 * i + 1))
                          for i in range(cs // 2)]
                if cs % 2:
                    steps.append((("short", cs - 1), None))
            convs.append(tuple(steps))
        out.append(tuple(convs))
    return tuple(out)


def _view_rows(blk: ConvBlockWeights, j: int, view: View) -> torch.Tensor:
    """The 8 K rows ``[8, C_out]`` (fp32) that a view multiplies."""
    co = blk.w1.shape[2]
    if view is None:
        return torch.zeros(8, co)
    if view[0] == "short":
        return blk.wd.float()[8 * view[1]:8 * view[1] + 8].cpu()
    _, d, c = view
    w = (blk.w1, blk.w2, blk.w3)[j].float()
    return w[d, 8 * c:8 * c + 8].cpu()


def wgmma_k_matrix(blk: ConvBlockWeights, j: int,
                   steps: Sequence[Tuple[View, View]]) -> torch.Tensor:
    """Conv j's GEMM weight ``[16 ks, C_out]`` in fp32, in the order of its
    k-steps."""
    return torch.cat([_view_rows(blk, j, v) for pair in steps for v in pair])


def _wgmma_woffs(chans) -> Tuple[Tuple[Tuple[int, ...], ...], int]:
    """Per block, per conv, its first element in the packed bf16 weights;
    the elements in all."""
    offs, woff = [], 0
    for (_, co, _), convs in zip(chans, wgmma_steps(chans)):
        o = []
        for steps in convs:
            o.append(woff)
            woff += 16 * len(steps) * co
        offs.append(tuple(o))
    return tuple(offs), woff


def stack_weights(blocks: Sequence[ConvBlockWeights]) -> ConvStackWeights:
    """Pack the blocks' taps for the kernel (see the module note)."""
    blocks = tuple(blocks)
    w1 = blocks[0].w1
    dt, dev = w1.dtype, w1.device
    try:
        chans = _chans(blocks)
        shapes, nw, nv = _stack_shapes(chans)
        if dt == torch.bfloat16:
            woffs, nw = _wgmma_woffs(chans)
    except ValueError:
        # widths the kernel does not take: the plain version serves them,
        # and a launch raises with the reason
        return ConvStackWeights(blocks, None, None)
    wpack = torch.zeros(nw, dtype=torch.float32)
    vec = torch.zeros(nv, dtype=torch.float32)
    for k, (blk, sh) in enumerate(zip(blocks, shapes)):
        co = sh.co
        for j, cs in enumerate(sh.convs):
            bias = (blk.b1, blk.b2, blk.b3 + blk.bd)[j]
            vec[cs.boff:cs.boff + co] = bias.float().cpu()
            if cs.k == 0:
                continue
            if dt == torch.bfloat16:
                m = to_wgmma_b(wgmma_k_matrix(blk, j,
                                              wgmma_steps(chans)[k][j]))
                woff = woffs[k][j]
            else:
                m = torch.zeros(cs.ksteps * 16, co)
                m[:cs.k] = _k_matrix(blk, j).cpu()
                woff = cs.woff
            wpack[woff:woff + m.numel()] = m.reshape(-1)
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
    path: str = "fma"       # fp32: CUDA-core FMAs


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

    bf16 takes the wgmma path (:func:`wgmma_plan`).  fp32 reads its
    weights from device memory; an SM's shared memory holds the tile's
    three activation slots."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv stack takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16:
        return wgmma_plan(rows, w0, chans, sms)
    esize, wfrag = 4, 0
    shapes, _, nvec = _stack_shapes(chans)
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


class ConvStackWgmmaPlan(NamedTuple):
    """One bf16 launch: what ``csrc/conv_stack.cu`` is given.  Offsets are
    bytes into a warpgroup's region of shared memory unless named
    otherwise."""

    wgs: int                # consumer warpgroups a block
    tile_rows: int          # rows a warpgroup's tile; a warpgroup walks
    #                         tiles grid * wgs apart
    grid: int               # blocks: one an SM
    smem: int               # bytes of dynamic shared memory a block
    region: int             # bytes of a warpgroup's region
    xbuf: int               # its input rows' bytes, at offset 0
    buffers: Tuple[Tuple[int, int, int, int], ...]   # each block's input,
    #                         h1, h2 and output: offsets into the region
    nvec: int               # floats of the vectors
    wfrag: int              # bf16 weight elements staged
    widths: Tuple[int, ...]       # each block's output width W
    row_stride: Tuple[int, ...]   # W + 2: positions a row, zero at both ends
    planes: Tuple[int, ...]       # each block's input: 1, or 2 even/odd
    plane_bytes: Tuple[int, ...]  # bytes a plane of each block's buffers
    convs: Tuple[Tuple[int, ...], ...]   # _CONV_INTS a conv (see the .cu)
    ksteps: Tuple[Tuple[int, int], ...]  # (A's offset at position 0, LBO)
    wgmma_convs: int        # convolutions a launch runs on wgmma
    dims: Tuple[int, ...]   # region, xbuf, k-steps, then convs and k-steps
    path: str = "wgmma"


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _wgmma_layout(w0: int, chans, tile_rows: int):
    """The per-warpgroup layout at ``tile_rows`` rows: widths, row strides,
    planes, plane bytes, each block's buffers (its input, h1, h2, output:
    offsets), the region's bytes and the input rows' bytes, which lie
    first.  The rest holds the largest working set of any conv, not three
    of the largest buffer."""
    widths, qs, pls, pbs, w = [], [], [], [], w0
    for _, _, stride in chans:
        w = (w - 1) // stride + 1
        widths.append(w)
        qs.append(w + 2)
        pls.append(stride)
        # a plane holds the tile's positions; a view reads from position -1
        # (the buffer before) to the last m-tile's end + 2 (whatever
        # follows, or the slack after the regions)
        pbs.append(tile_rows * (w + 2) * 16)
    xbuf = _round16(tile_rows * w0 * 2 + 32)
    # bytes of each block's input (block 0's: the input rows, apart), of
    # h1 and h2, and of its output (the next block's input, or the result)
    sizes, x = [], 0
    for k, (_, co, _) in enumerate(chans):
        h = co // 8 * pbs[k]
        out = (co // 8 * pls[k + 1] * pbs[k + 1] if k + 1 < len(chans)
               else _round16(tile_rows * co * widths[-1] * 2))
        sizes.append((x, h, out))
        x = out
    # block k's input sits at one end of the space, h2 beside it, h1 and
    # the output at the other end (h1 is dead when conv3 writes the output),
    # the ends swapping block by block: the space is the largest working set
    span = max(x + h + max(h, out) for x, h, out in sizes)
    bufs, x_off = [], 0
    for k, (x, h, out) in enumerate(sizes):
        if k % 2 == 0:   # the input at the low end
            bufs.append((x_off, xbuf + span - h, xbuf + x, xbuf + span - out))
        else:
            bufs.append((x_off, xbuf, xbuf + span - x - h, xbuf))
        x_off = bufs[-1][3]
    region = xbuf + span
    return (tuple(widths), tuple(qs), tuple(pls), tuple(pbs), tuple(bufs),
            region, xbuf)


def _tile_cost(tile_rows: int, chans, qs) -> float:
    """A tile's SM clocks by a rough model, to rank tile sizes: 2 MUFU a
    SiLU at 16 a clock for every position of the warps' 16-row bands, an
    m-tile's k-step at 128 bytes a clock of shared memory (A 2 KB, B 32 N
    bytes), and a fixed cost a conv."""
    cost = 0.0
    for steps, (ci, co, _), q in zip(wgmma_steps(tuple(chans)), chans, qs):
        mp = tile_rows * q
        for st in steps:
            cost += 16 * -(-mp // 16) * co / 8 + 200
            cost += -(-mp // _M) * len(st) * (16 + co / 4)
    return cost


@functools.lru_cache(maxsize=None)
def wgmma_plan(rows: int, w0: int, chans: Tuple[Tuple[int, int, int], ...],
               sms: int = SMS) -> ConvStackWgmmaPlan:
    """The bf16 launch.  Pure: the CPU tests hold it.

    A block stages the vectors, the weights and the plan's tables in
    shared memory and gives each warpgroup a region of the rest: its input
    rows and its buffers (:func:`_wgmma_layout`).  Each warpgroup walks
    its own tiles, so one warpgroup's epilogues (SiLUs on the SFU) overlap
    another's products.
    The plan takes the most warpgroups (up to 5) at which tiles of 3 rows
    fit, else 2: 3 rows of the narrowest blocks (W + 2 = 17-19 positions)
    fill most of a 64-position m-tile, and more warpgroups at 2 rows ran no
    faster on the H100.  Then the tile rows that the cost model ranks
    first over the rounds of tiles the grid leaves; the grid fills the SMs
    where the tiles do."""
    shapes, _, nvec = _stack_shapes(chans)
    for k, (ci, co, stride) in enumerate(chans):
        if co > 8 * _MAX_W_NT or stride not in (1, 2) or (k and ci == 1):
            raise ValueError(
                f"block {k}: {ci} -> {co} channels, stride {stride}; the "
                f"bf16 kernel takes up to {8 * _MAX_W_NT} channels out, "
                f"strides 1 and 2, and 1 channel in only in block 0")
    steps = wgmma_steps(chans)
    woffs, wfrag = _wgmma_woffs(chans)
    nkst = sum(len(st) for convs in steps for st in convs)
    if nkst > _MAX_KSTEPS:
        raise ValueError(f"{nkst} k-steps; the kernel takes {_MAX_KSTEPS}")
    fixed = (_round16(nvec * 4) + _round16(wfrag * 2)
             + _round16((3 * len(chans) * _CONV_INTS + 2 * nkst) * 4)
             + _SLACK)

    def most_rows(wgs):
        tr = 0
        while fixed + wgs * _wgmma_layout(w0, chans, tr + 1)[5] <= SMEM_LIMIT:
            tr += 1
        return tr

    wgs = _MAX_WGS
    while wgs > 2 and most_rows(wgs) < _WG_ROWS:
        wgs -= 1
    best = None
    for tr in range(1, min(most_rows(wgs), rows) + 1):
        lay = _wgmma_layout(w0, chans, tr)
        ntiles = -(-rows // tr)
        grid = min(sms, -(-ntiles // wgs))
        cost = -(-ntiles // (grid * wgs)) * _tile_cost(tr, chans, lay[1])
        if best is None or cost <= best[0]:
            best = (cost, tr, grid, lay)
    if best is None:
        raise ValueError(f"one row of {w0} features needs more shared memory "
                         f"than the {SMEM_LIMIT} bytes of a block")
    _, tr, grid, lay = best
    widths, qs, pls, pbs, bufs, region, xbuf = lay
    convs, kst = [], []
    for k, ((ci, co, stride), sh) in enumerate(zip(chans, shapes)):
        x_off, h1, h2, out = bufs[k]
        last = k == len(chans) - 1
        srcs = ((x_off, pls[k]), (h1, 1), (h2, 1))
        for j in range(3):
            src, par = srcs[j]

            def addr(v, src=src, par=par, pb=pbs[k]):
                """A view's bytes at output position 0: stride 1 reads
                position d - 1; stride 2 entry -1, -1, 0 of the even, odd,
                even plane (the shortcut: the odd plane's -1)."""
                if v[0] == "short":
                    c = v[1]
                    if pls[k] == 1:
                        return x_off + c * pb
                    return x_off + (2 * c + 1) * pb - 16
                _, d, c = v
                if par == 1:
                    return src + c * pb + (d - 1) * 16
                odd, shift = ((0, -1), (1, -1), (0, 0))[d]
                return src + (2 * c + odd) * pb + shift * 16
            first = len(kst)
            for va, vb in steps[k][j]:
                at = addr(va)
                kst.append((at, 16 if vb is None else addr(vb) - at))
            if j < 2:
                dst, dpb, dp, dq = (h1, h2)[j], pbs[k], 1, qs[k]
            elif last:
                dst, dpb, dp, dq = out, 0, 0, qs[k]
            else:
                dst, dpb, dp, dq = out, pbs[k + 1], pls[k + 1], qs[k + 1]
            elementwise = j == 0 and ci == 1
            convs.append((
                1 if elementwise else 0, co // 8, len(kst) - first, first,
                2 * woffs[k][j], sh.convs[j].boff, tr * qs[k], qs[k], dst,
                dpb, dp, dq, sh.wdoff if j == 2 and ci == 1 else -1, stride,
                sh.w1off if elementwise else -1, co))
    dims = [region, xbuf, len(kst)] + [v for c in convs for v in c] + [
        v for e in kst for v in e]
    return ConvStackWgmmaPlan(
        wgs, tr, grid, fixed + wgs * region, region, xbuf, bufs, nvec, wfrag,
        widths, qs, pls, pbs, tuple(convs), tuple(kst),
        sum(1 for c in convs if c[0] == 0), tuple(dims))


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
    if stack.vec.numel() != plan.nvec or (
            plan.path == "wgmma" and stack.wpack.numel() != plan.wfrag):
        raise ValueError("the packed weights do not match the blocks")
    co = stack.blocks[-1].w1.shape[2]
    out = torch.empty((rows, co, plan.widths[-1]), dtype=dt, device=dev)
    dims = (ctypes.c_int * len(plan.dims))(*plan.dims)
    # bf16: the C side takes the warpgroups in row_elems' place
    per_tile = plan.row_elems if plan.path == "fma" else plan.wgs
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), rows, w0, plan.tile_rows,
                  per_tile, plan.grid, len(stack.blocks), dims,
                  ptr(stack.wpack), ptr(stack.vec), plan.nvec, plan.wfrag,
                  ctypes.c_size_t(plan.smem), stream_ptr(dev))
    if plan.path == "wgmma":
        global wgmma_convs
        wgmma_convs += plan.wgmma_convs
        trace.count("serve.conv_stack_wgmma_convs", plan.wgmma_convs)
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
