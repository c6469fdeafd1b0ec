"""Fused eval dual axial attention: CUDA kernel, plain version, packer.

Counterpart of ``wiflow_tpu/ops/pallas/axial_attention.py``
(``dual_axial_attention_eval_v2`` over ``axial_attention_eval_v2``).  On
``x [B, H, W, C]``, attention runs along W (L = W) and then along H
(L = H).  Per axis, with the eval BNs folded:

    qkv = x @ Wq + bq                         bn_qkv folded into Wq, bq
    logit[g, i, j] = (q_i . k_j)_g * s_g + b_g    bn_similarity
    o = softmax_j(logit) @ v
    out = o * so + bo                         bn_output, rounded to x.dtype

Channels stay in the standard group-major order (channel = g*gc + cc):
the TPU kernel's scrambled order was a tiling choice, so the port needs no
permutation downstream.  On a CUDA tensor each axis is one launch of
``csrc/axial_attention.cu``, which reads the height axis's columns in
place through a sequence stride; on a CPU tensor the plain version runs.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Tuple

import torch

from wiflow_tpu_torch.ops.kernels.build import (
    CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)
from wiflow_tpu_torch.ops.norm import folded_bn

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("axial_attention", "axial_attention_forward",
                    [_I, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I,
                     _P, _P, _P, _P, ctypes.c_size_t, _P],
                    replaces="wiflow_tpu/ops/pallas/axial_attention.py:291")
_GROUP_CHANNELS = 8
_MAX_POSITIONS = 80
_WEIGHT_TILE_BYTES = 32 * 64 * 4


class AxisWeights(NamedTuple):
    """One attention axis, BNs folded."""

    wq: torch.Tensor     # [C, 3C] compute dtype (bn_qkv folded)
    bq: torch.Tensor     # [3C] fp32
    sim: torch.Tensor    # [2, G] fp32: bn_similarity (scale, bias)
    oaff: torch.Tensor   # [2, C] fp32: bn_output (scale, bias)


def pack_axial_attention(state_dict: Mapping[str, torch.Tensor],
                         prefix: str = "attention", *, dtype: torch.dtype,
                         device: torch.device
                         ) -> Tuple[AxisWeights, AxisWeights]:
    """Fold the BNs of ``{prefix}.width_axis`` / ``.height_axis``, once."""
    axes = []
    for axis in ("width_axis", "height_axis"):
        p = f"{prefix}.{axis}"
        sc, bi = folded_bn(state_dict, f"{p}.bn_qkv")
        w = state_dict[f"{p}.qkv_transform.weight"].float()[:, :, 0]  # [3C, C]
        wq = (w * sc[:, None]).t()
        sim = torch.stack(folded_bn(state_dict, f"{p}.bn_similarity"))
        oaff = torch.stack(folded_bn(state_dict, f"{p}.bn_output"))
        f32 = dict(device=device, dtype=torch.float32)
        axes.append(AxisWeights(wq.to(device=device, dtype=dtype).contiguous(),
                                bi.to(**f32).contiguous(),
                                sim.to(**f32).contiguous(),
                                oaff.to(**f32).contiguous()))
    return axes[0], axes[1]


def axial_attention_plain(x: torch.Tensor, aw: AxisWeights,
                          width: bool) -> torch.Tensor:
    """Stock-torch version of one kernel launch on ``[B, H, W, C]``."""
    b, h, w, c = x.shape
    g = aw.sim.shape[1]
    xr = x.reshape(b * h, w, c) if width else \
        x.transpose(1, 2).reshape(b * w, h, c)
    n, length, _ = xr.shape
    qkv = xr.float() @ aw.wq.float() + aw.bq
    q, k, v = (t.reshape(n, length, g, c // g)
               for t in torch.split(qkv, c, dim=-1))
    lg = torch.einsum("nigc,njgc->ngij", q, k)
    lg = lg * aw.sim[0][None, :, None, None] + aw.sim[1][None, :, None, None]
    p = torch.softmax(lg, dim=-1)
    o = torch.einsum("ngij,njgc->nigc", p, v).reshape(n, length, c)
    out = (o * aw.oaff[0] + aw.oaff[1]).to(x.dtype)
    if width:
        return out.reshape(b, h, w, c)
    return out.reshape(b, w, h, c).transpose(1, 2).contiguous()


def _launch(x: torch.Tensor, aw: AxisWeights, width: bool) -> torch.Tensor:
    b, h, w, c = x.shape
    dev, dt = x.device, x.dtype
    g = aw.sim.shape[1]
    check_tensor(x, "x", device=dev, dtype=dt)
    check_tensor(aw.wq, "wq", device=dev, dtype=dt, shape=(c, 3 * c))
    check_tensor(aw.bq, "bq", device=dev, dtype=torch.float32,
                 shape=(3 * c,))
    check_tensor(aw.sim, "sim", device=dev, dtype=torch.float32,
                 shape=(2, g))
    check_tensor(aw.oaff, "oaff", device=dev, dtype=torch.float32,
                 shape=(2, c))
    if c != g * _GROUP_CHANNELS:
        raise ValueError(f"the kernel takes {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={g}")
    if width:      # sequences (b, h) along W
        length, n_inner, inner, seq = w, h, w * c, c
    else:          # sequences (b, w) along H, read as strided columns
        length, n_inner, inner, seq = h, w, c, w * c
    if length > 32:
        raise ValueError(f"sequence length {length} > 32")
    seqs = _MAX_POSITIONS // length
    npos = seqs * length
    smem = _WEIGHT_TILE_BYTES + npos * (3 * c + 4) * 4 + npos * c * \
        x.element_size()
    out = torch.empty_like(x)
    KERNEL.launch(dtype_code(dt), ptr(x), ptr(out), b * n_inner, length, c, g,
                  n_inner, inner, h * w * c, seq, seqs, ptr(aw.wq),
                  ptr(aw.bq), ptr(aw.sim), ptr(aw.oaff),
                  ctypes.c_size_t(smem), stream_ptr(dev))
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
