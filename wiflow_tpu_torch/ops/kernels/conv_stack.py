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
packer keeps the plain ``[3, C_in, C_out]`` taps.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from wiflow_tpu_torch.ops.kernels.build import (
    CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)
from wiflow_tpu_torch.ops.norm import folded_bn

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("conv_stack", "conv_stack_forward",
                    [_I, _P, _P, _I, _I, _I, _I, _P, _P, ctypes.c_size_t, _P],
                    replaces="wiflow_tpu/ops/pallas/conv_stack.py:218")
_MAX_BLOCKS = 8
# Shared memory per thread block kept under half an SM's, so two blocks
# share an SM.
_SMEM_BUDGET = 113 * 1024
_OUT_PER_THREAD = 8


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
                    device: torch.device) -> List[ConvBlockWeights]:
    """Fold the BNs of ``up`` and ``residual_blocks.{j}`` (torch layouts,
    reference names) into ``[3, C_in, C_out]`` taps, once."""
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
    return blocks


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


def _launch(x: torch.Tensor,
            blocks: Sequence[ConvBlockWeights]) -> torch.Tensor:
    rows, w = x.shape
    dev, dt = x.device, x.dtype
    check_tensor(x, "x", device=dev, dtype=dt)
    if not 1 <= len(blocks) <= _MAX_BLOCKS:
        raise ValueError(f"1..{_MAX_BLOCKS} conv blocks, got {len(blocks)}")
    dims: List[int] = []
    ptrs: List[int] = []
    act = w                          # largest per-row activation, elements
    wfloats = 0                      # largest staged weight set, floats
    ci = 1
    for k, blk in enumerate(blocks):
        co = blk.w1.shape[2]
        if co % _OUT_PER_THREAD:
            raise ValueError(f"block {k}: C_out={co} is not a multiple of "
                             f"{_OUT_PER_THREAD}")
        wout = (w - 1) // blk.stride + 1
        for name, shape in (("w1", (3, ci, co)), ("w2", (3, co, co)),
                            ("w3", (3, co, co)), ("wd", (ci, co))):
            check_tensor(getattr(blk, name), f"block {k} {name}", device=dev,
                         dtype=dt, shape=shape)
        for name in ("b1", "b2", "b3", "bd"):
            check_tensor(getattr(blk, name), f"block {k} {name}", device=dev,
                         dtype=torch.float32, shape=(co,))
        dims += [ci, co, blk.stride, w, wout]
        ptrs += [t.data_ptr() for t in (blk.w1, blk.b1, blk.w2, blk.b2,
                                        blk.w3, blk.b3, blk.wd, blk.bd)]
        act = max(act, ci * w, co * wout)
        wfloats = max(wfloats, 3 * ci * co, 3 * co * co + ci * co)
        ci, w = co, wout
    buf = -(-act // 8) * 8
    esize = x.element_size()
    block_rows = min(8, (_SMEM_BUDGET - 4 * wfloats) // (3 * buf * esize))
    if block_rows < 1:
        raise ValueError("one row's activations do not fit a thread block")
    smem = 3 * block_rows * buf * esize + 4 * wfloats
    out = torch.empty((rows, ci, w), dtype=dt, device=dev)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), rows, block_rows, buf,
                  len(blocks), c_dims, c_ptrs, ctypes.c_size_t(smem),
                  stream_ptr(dev))
    return out


def fused_conv_stack_eval(x: torch.Tensor,
                          blocks: Sequence[ConvBlockWeights]) -> torch.Tensor:
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
