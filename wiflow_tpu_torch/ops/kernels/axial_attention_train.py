"""Train-mode attention core and logits sums: CUDA kernels, plain versions.

Counterpart of ``wiflow_tpu/ops/pallas/axial_attention_train.py``.  On
``q, k, v [N, L, C]`` (N sequences of L positions, channels in the
standard group-major order, ``channel = g * gc + cc``):

    axial_core(q, k, v, scale)  = softmax_j(scale_g * q_i . k_j) @ v
    logits_sums(q, k, groups)   = [sum, sum of squares] of the raw logits
                                  q_i . k_j over (n, i, j), per group: [2, G]

Both are ``torch.autograd.Function``s whose forward and backward are
kernels (``csrc/axial_core.cu``, ``csrc/logits_sums.cu``, 8 channels per
group); the backwards recompute the logits rather than save them.  The
BatchNorm on the logits reduces to the per-group scale
``gamma * rsqrt(var + eps)`` (``models/wiflow.py::AxialAttention``), and
``logits_moments_fused`` gives the batch (mean, var) it needs from the
sums.  q, k and v may be the thirds of one ``[N, L, 3C]`` projection: the
kernels read them in place through their position stride.

A CUDA tensor goes through the kernels (or raises); a CPU tensor through
the plain versions, stock torch ops that autograd differentiates.  The
TPU kernels' scrambled ``[L, C, N]`` layout and lane padding are not
carried over.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from wiflow_tpu_torch.ops.kernels.build import (
    CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_TPU = "wiflow_tpu/ops/pallas/axial_attention_train.py"
CORE_FORWARD = CudaKernel(
    "axial_core", "axial_core_forward",
    [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    replaces=f"{_TPU}:217")
CORE_BACKWARD = CudaKernel(
    "axial_core", "axial_core_backward",
    [_I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    replaces=f"{_TPU}:244")
SUMS_FORWARD = CudaKernel(
    "logits_sums", "logits_sums_forward",
    [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    replaces=f"{_TPU}:354")
SUMS_BACKWARD = CudaKernel(
    "logits_sums", "logits_sums_backward",
    [_I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    replaces=f"{_TPU}:373")
KERNELS = (CORE_FORWARD, CORE_BACKWARD, SUMS_FORWARD, SUMS_BACKWARD)

_GROUP_CHANNELS = 8
_MAX_LEN = 32
_POSITIONS_PER_BLOCK = 80


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc(t: torch.Tensor) -> torch.Tensor:
    """The accumulation type: fp32, or float64 for float64 inputs."""
    return t if t.dtype == torch.float64 else t.float()


def axial_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``softmax_j(scale_g * q_i . k_j) @ v`` in stock torch ops; the
    output has q's dtype."""
    n, length, c = q.shape
    g = scale.shape[0]
    qf, kf, vf = (_acc(t).reshape(n, length, g, c // g) for t in (q, k, v))
    lg = torch.einsum("nigc,njgc->ngij", qf, kf)
    p = torch.softmax(lg * _acc(scale)[None, :, None, None], dim=-1)
    out = torch.einsum("ngij,njgc->nigc", p, vf)
    return out.reshape(n, length, c).to(q.dtype)


def logits_sums_plain(q: torch.Tensor, k: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """``[2, G]`` sums of the logits and their squares through the Gram
    identity ``sum_ij (q_i . k_j)^2 = <Q^T Q, K^T K>``, no logits."""
    n, length, c = q.shape
    gc = c // groups
    qf = _acc(q).reshape(n, length, groups, gc)
    kf = _acc(k).reshape(n, length, groups, gc)
    s1 = torch.einsum("ngc,ngc->g", qf.sum(1), kf.sum(1))
    gq = torch.einsum("nigc,nigd->ngcd", qf, qf)
    gk = torch.einsum("nigc,nigd->ngcd", kf, kf)
    s2 = torch.einsum("ngcd,ngcd->g", gq, gk)
    return torch.stack([s1, s2])


def _moments(sums: torch.Tensor, count: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = sums[0] / count
    return mean, sums[1] / count - mean * mean


def logits_moments(q: torch.Tensor, k: torch.Tensor, groups: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-group (mean, biased var) of the logits, plain version."""
    n, length, _ = q.shape
    return _moments(logits_sums_plain(q, k, groups), n * length * length)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _rows(ts: Sequence[torch.Tensor], names: Sequence[str]
          ) -> Tuple[List[torch.Tensor], int]:
    """Check ``[N, L, C]`` inputs of one device and dtype; return them with
    their common position stride ``ld`` when they share the strides
    ``(L * ld, ld, 1)`` (e.g. thirds of one ``[N, L, 3C]`` tensor), else
    contiguous copies and ``ld = C``."""
    n, length, c = ts[0].shape
    dev, dt = ts[0].device, ts[0].dtype
    for t, name in zip(ts, names):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (n, length, c):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected {(n, length, c)} {dt} on "
                             f"{dev}")
    dtype_code(dt)
    if c % _GROUP_CHANNELS or not 1 <= length <= _MAX_LEN:
        raise ValueError(f"the kernels take L <= {_MAX_LEN} and "
                         f"{_GROUP_CHANNELS} channels per group, got "
                         f"L={length}, C={c}")
    ld = ts[0].stride(1)
    if ld >= c and all(t.stride() == (length * ld, ld, 1) for t in ts):
        return list(ts), ld
    return [t.contiguous() for t in ts], c


def _launch_shape(q: torch.Tensor, groups: int) -> Tuple[int, int, int, int]:
    n, length, c = q.shape
    if c != groups * _GROUP_CHANNELS:
        raise ValueError(f"the kernels take {_GROUP_CHANNELS} channels per "
                         f"group, got C={c}, G={groups}")
    seqs = max(1, _POSITIONS_PER_BLOCK // length)
    return n, length, seqs, -(-n // seqs)


def axial_core_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel: ``out [N, L, C]`` in q's dtype."""
    (q, k, v), ld = _rows((q, k, v), ("q", "k", "v"))
    g = scale.shape[0]
    dev, dt = q.device, q.dtype
    check_tensor(scale, "scale", device=dev, dtype=torch.float32, shape=(g,))
    n, length, seqs, _ = _launch_shape(q, g)
    c = q.shape[2]
    out = torch.empty((n, length, c), device=dev, dtype=dt)
    CORE_FORWARD.launch(dtype_code(dt), ptr(q), ptr(k), ptr(v), ld, ptr(out),
                        n, length, c, g, seqs, ptr(scale), stream_ptr(dev))
    return out


def axial_core_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """One launch of the backward kernel (and its float64 reduction of
    dscale): ``(dq, dk, dv)`` in q's dtype and ``dscale [G]`` fp32."""
    (q, k, v), ld = _rows((q, k, v), ("q", "k", "v"))
    g = scale.shape[0]
    dev, dt = q.device, q.dtype
    check_tensor(scale, "scale", device=dev, dtype=torch.float32, shape=(g,))
    dout = dout.contiguous()
    check_tensor(dout, "dout", device=dev, dtype=dt, shape=q.shape)
    n, length, seqs, blocks = _launch_shape(q, g)
    c = q.shape[2]
    dq, dk, dv = (torch.empty((n, length, c), device=dev, dtype=dt)
                  for _ in range(3))
    partial = torch.empty((blocks, g), device=dev, dtype=torch.float32)
    dscale = torch.empty((g,), device=dev, dtype=torch.float32)
    CORE_BACKWARD.launch(dtype_code(dt), ptr(q), ptr(k), ptr(v), ld,
                         ptr(dout), ptr(dq), ptr(dk), ptr(dv), n, length, c,
                         g, seqs, ptr(scale), ptr(partial), ptr(dscale),
                         stream_ptr(dev))
    return dq, dk, dv, dscale


def logits_sums_forward(q: torch.Tensor, k: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """One launch of the forward kernel (and its float64 reduction over
    blocks): ``[2, G]`` fp32."""
    (q, k), ld = _rows((q, k), ("q", "k"))
    dev = q.device
    n, length, seqs, blocks = _launch_shape(q, groups)
    partial = torch.empty((blocks, 2 * groups), device=dev,
                          dtype=torch.float32)
    sums = torch.empty((2, groups), device=dev, dtype=torch.float32)
    SUMS_FORWARD.launch(dtype_code(q.dtype), ptr(q), ptr(k), ld, n, length,
                        q.shape[2], groups, seqs, ptr(partial), ptr(sums),
                        stream_ptr(dev))
    return sums


def logits_sums_backward(q: torch.Tensor, k: torch.Tensor,
                         dsums: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel: ``(dq, dk)`` in q's dtype."""
    (q, k), ld = _rows((q, k), ("q", "k"))
    groups = dsums.shape[-1]
    dev, dt = q.device, q.dtype
    dsums = dsums.float().contiguous()
    check_tensor(dsums, "dsums", device=dev, dtype=torch.float32,
                 shape=(2, groups))
    n, length, seqs, _ = _launch_shape(q, groups)
    c = q.shape[2]
    dq, dk = (torch.empty((n, length, c), device=dev, dtype=dt)
              for _ in range(2))
    SUMS_BACKWARD.launch(dtype_code(dt), ptr(q), ptr(k), ld, ptr(dsums),
                         ptr(dq), ptr(dk), n, length, c, groups, seqs,
                         stream_ptr(dev))
    return dq, dk


class _AxialCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v, scale)
        return axial_core_forward(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return axial_core_backward(*ctx.saved_tensors, dout)


class _LogitsSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, groups):
        ctx.save_for_backward(q, k)
        return logits_sums_forward(q, k, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dsums):
        return (*logits_sums_backward(*ctx.saved_tensors, dsums), None)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")


def axial_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """``softmax_j(scale_g * q_i . k_j) @ v`` on ``[N, L, C]``,
    differentiable in q, k, v and ``scale [G]`` (fp32)."""
    if _on_cuda(q, "axial_core"):
        return _AxialCore.apply(q, k, v, scale)
    return axial_core_plain(q, k, v, scale)


def logits_sums(q: torch.Tensor, k: torch.Tensor,
                groups: int) -> torch.Tensor:
    """``[2, G]`` fp32: sum and sum of squares of the logits over
    (n, i, j), differentiable in q and k."""
    if _on_cuda(q, "logits_sums"):
        return _LogitsSums.apply(q, k, groups)
    return logits_sums_plain(q, k, groups)


def logits_moments_fused(q: torch.Tensor, k: torch.Tensor, groups: int,
                         count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch (mean, biased var) of the logits from :func:`logits_sums`;
    ``count = N * L * L``."""
    return _moments(logits_sums(q, k, groups), count)
