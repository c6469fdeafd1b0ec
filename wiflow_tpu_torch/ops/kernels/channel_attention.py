"""WPformer's channel attention core, eval: CUDA kernel, plain version, plan.

The core of ``models/baselines/wpformer.py::ChannelAttention`` (ref
ChannelTrans.py:82-168) on the packed projection ``qkv [B, N, 3 H C]``
(columns ``q_0 .. q_{H-1}, k_0 .., v_0 ..``, each ``[N, C]``)::

    S_h = Q_h^T K_h / sqrt(C)                  [C, C], fp32
    Z_h = InstanceNorm(S_h)                    one mean and one variance
                                               over all C x C entries
    P_h = softmax_rows(Z_h), rounded to bf16
    out = (1 / H) sum_h V_h P_h^T              [N, C], fp32 sums, bf16

On a CUDA tensor it is one launch of ``csrc/channel_attention.cu`` (a
cluster of C / 64 CTAs a window, the scores kept on chip, their
statistics merged over distributed shared memory), sized by
:func:`channel_attention_plan`; on a CPU tensor :func:`channel_attention_plain`
runs, which repeats the kernel's arithmetic in stock ops.  The kernel
takes bfloat16 and C of 64, 128 or 256; WPformer's served path has N =
2,160, C = 256, H = 3.  It replaces no TPU kernel (the JAX package leaves
this core to XLA).

Where it departs from the model's own core
(``wpformer.channel_attention_core``): the heads' contexts are summed in
fp32 and rounded once, where the model rounds each head's context to the
compute dtype before the mean.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from wiflow_tpu_torch.ops.kernels.build import (
    SMEM_LIMIT, CudaKernel, check_tensor, ptr, stream_ptr,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("channel_attention", "channel_attention_forward",
                    [_P, _P, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float,
                     _I, ctypes.c_size_t, _P],
                    replaces="none: the JAX package leaves it to XLA")
EPS = 1e-5                    # InstanceNorm2d's
CHANNELS = (64, 128, 256)     # C the kernel takes: a CTA a 64-row block
_ROWS = 64
_TOK_A, _STAGES_A = 32, 3     # the scores' ring (csrc: kTokA, kStagesA)
_TOK_B, _STAGES_B = 64, 2     # the context's ring (kTokB, kStagesB)
_WARPS = 8
_MAX_GRID_Y = 65535


class ChannelAttentionPlan(NamedTuple):
    cluster: int       # CTAs a window (C / 64), one cluster
    grid_y: int        # windows in flight; a cluster walks b += grid_y
    smem_bytes: int    # dynamic shared memory a CTA


def smem_layout(c: int, heads: int) -> int:
    """Bytes of a CTA's shared memory (``csrc``'s ``layout``): every head's
    64 rows of P, the larger of the two rings, the softmax's row maxima
    and sums, a float a warp and each head's two statistics."""
    row = (c + 8) * 2
    p = heads * _ROWS * row
    stage_a = _TOK_A * (_ROWS + 8) * 2 + _TOK_A * row
    stage = max(_STAGES_A * stage_a, _STAGES_B * _TOK_B * row)
    red = (2 * 2 * _ROWS + _WARPS) * 4
    stats = -(-heads * 2 * 4 // 16) * 16
    return p + stage + red + stats


@functools.lru_cache(maxsize=None)
def channel_attention_plan(batch: int, n: int, c: int, heads: int,
                           dtype: torch.dtype) -> ChannelAttentionPlan:
    """The launch of ``batch`` windows of ``n`` tokens, ``c`` channels and
    ``heads`` heads; raises ``ValueError`` for what the kernel does not
    take."""
    if dtype != torch.bfloat16:
        raise ValueError(f"channel attention kernel: bfloat16 only, got "
                         f"{dtype}")
    if c not in CHANNELS:
        raise ValueError(f"channel attention kernel: C must be one of "
                         f"{CHANNELS}, got {c}")
    if batch < 1 or n < 1 or heads < 1:
        raise ValueError(f"channel attention kernel: batch {batch}, tokens "
                         f"{n}, heads {heads} must be positive")
    smem = smem_layout(c, heads)
    if smem > SMEM_LIMIT:
        raise ValueError(f"channel attention kernel: {heads} heads at C = "
                         f"{c} need {smem} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    return ChannelAttentionPlan(c // _ROWS, min(batch, _MAX_GRID_Y), smem)


def split_heads(qkv: torch.Tensor, heads: int):
    """``q, k, v [B, H, N, C]`` views of ``qkv [B, N, 3 H C]``."""
    b, n, w = qkv.shape
    parts = qkv.view(b, n, 3, heads, w // (3 * heads)).permute(2, 0, 3, 1, 4)
    return parts[0], parts[1], parts[2]


def channel_attention_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The kernel's arithmetic in stock ops: ``[B, N, C]`` in ``qkv``'s
    dtype."""
    q, k, v = split_heads(qkv, heads)
    c = q.shape[-1]
    s = torch.einsum("bhnc,bhnd->bhcd", q.float(), k.float()) / math.sqrt(c)
    mean = s.mean(dim=(-2, -1), keepdim=True)
    var = s.var(dim=(-2, -1), keepdim=True, unbiased=False)
    p = torch.softmax((s - mean) * torch.rsqrt(var + EPS), dim=-1)
    p = p.to(qkv.dtype).float()
    ctx = torch.einsum("bhcd,bhnd->bnc", p, v.float()) / heads
    return ctx.to(qkv.dtype)


def channel_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """``qkv [B, N, 3 H C]`` -> the heads' mean context ``[B, N, C]``: the
    kernel on a CUDA tensor (it launches or raises), the plain version on
    a CPU one."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be [B, N, 3 x {heads} x C], got "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type != "cuda":
        return channel_attention_plain(qkv, heads)
    b, n, w = qkv.shape
    c = w // (3 * heads)
    plan = channel_attention_plan(b, n, c, heads, qkv.dtype)
    check_tensor(qkv, "qkv", device=qkv.device, dtype=torch.bfloat16)
    out = torch.empty((b, n, c), device=qkv.device, dtype=qkv.dtype)
    KERNEL.launch(ptr(qkv), ptr(out), b, n, c, heads, math.sqrt(c), EPS,
                  plan.grid_y, plan.smem_bytes, stream_ptr(qkv.device))
    return out
