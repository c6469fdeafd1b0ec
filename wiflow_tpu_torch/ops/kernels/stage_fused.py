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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from wiflow_tpu_torch.ops.kernels.build import (
    CudaKernel, check_tensor, dtype_code, ptr, stream_ptr,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TPU = "wiflow_tpu/ops/pallas/stage_fused.py"
STAGE_FORWARD = CudaKernel(
    "stage_fused", "stage_forward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _P] + [_I] * 12 + [_P],
    replaces=f"{_TPU}:516")
STAGE_BACKWARD = CudaKernel(
    "stage_fused", "stage_backward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I]
    + [_I] * 16 + [_P],
    replaces=f"{_TPU}:596")
JOIN_FORWARD = CudaKernel(
    "join_fused", "join_forward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
     _P],
    replaces=f"{_TPU}:839")
JOIN_BACKWARD = CudaKernel(
    "join_fused", "join_backward",
    [_I, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _P],
    replaces=f"{_TPU}:879")
KERNELS = (STAGE_FORWARD, STAGE_BACKWARD, JOIN_FORWARD, JOIN_BACKWARD)

# (taps, stride, pad) of each geometry; the tap j of output position wo
# reads input position wo * stride + (j - pad) * dil
_KINDS = {"causal3": (3, 1, 2), "identity": (1, 1, 0), "sym3": (3, 1, 1),
          "chunk3": (3, 2, 1), "chunk1": (1, 2, 0)}
# thread blocks a launch aims for: a few per SM of the card's 132
_TARGET_BLOCKS = 1056


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


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _tile_n(channels: int) -> int:
    """The tile width (8, 16, 32 or 64) that holds ``channels`` columns
    with the least padding."""
    return next((t for t in (8, 16, 32) if channels <= t), 64)


def _grid_x(positions: int, tile_m: int, grid_y: int) -> int:
    return min(-(-positions // tile_m), max(1, _TARGET_BLOCKS // grid_y))


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
    return mask.contiguous(), div


def stage_forward(x: torch.Tensor, m, a, b, mask, weight: torch.Tensor, bias,
                  *, kind: str, dil: int = 1, keep: float = 1.0,
                  stats: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel (and, with ``stats``, its float64
    reduction over blocks)."""
    g = _geometry(x, weight, kind, dil)
    dev, dt = x.device, x.dtype
    code = dtype_code(dt)
    x = x.contiguous()
    m, a, b = _prologue(m, a, b, dev, g.ci, "stage")
    mask, div = _mask_arg(mask, x)
    w = _vec(weight.reshape(-1), "weight", dev, weight.numel())
    bias = _vec(bias, "bias", dev, g.co)
    tn = _tile_n(g.co // g.groups)
    grid_y = g.groups * -(-(g.co // g.groups) // tn)
    grid_x = _grid_x(g.rows * g.wout, 4096 // tn, grid_y)
    out = torch.empty((*x.shape[:-2], g.wout, g.co), device=dev, dtype=dt)
    partial = sums = None
    if stats:
        partial = torch.empty((grid_x, 2, g.co), device=dev,
                              dtype=torch.float32)
        sums = torch.empty((2, g.co), device=dev, dtype=torch.float32)
    STAGE_FORWARD.launch(code, ptr(x), ptr(m), ptr(a), ptr(b), ptr(mask), div,
                         keep, ptr(w), ptr(bias), ptr(out), ptr(partial),
                         ptr(sums), *g, tn, grid_x, stream_ptr(dev))
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
    x = x.contiguous()
    m, a, b = _prologue(m, a, b, dev, g.ci, "stage")
    mask, div = _mask_arg(mask, x)
    w = _vec(weight.reshape(-1), "weight", dev, weight.numel())
    oshape = (*x.shape[:-2], g.wout, g.co)
    go = go.contiguous()
    check_tensor(go, "go", device=dev, dtype=dt, shape=oshape)
    if (out is None) != (gsums is None):
        raise ValueError("give both out and gsums, or neither")
    if gsums is not None:
        out = out.contiguous()
        check_tensor(out, "out", device=dev, dtype=dt, shape=oshape)
        gsums = _vec(gsums.reshape(-1), "gsums", dev, 2 * g.co)
    cig, cog = g.ci // g.groups, g.co // g.groups

    gx = partial_ab = gmab = None
    tn_d, grid_x_d = _tile_n(cig), 1
    if need_gx:
        grid_y = g.groups * -(-cig // tn_d)
        grid_x_d = _grid_x(g.rows * g.win, 4096 // tn_d, grid_y)
        gx = torch.empty_like(x)
        if a is not None:
            partial_ab = torch.empty((grid_x_d, 2, g.ci), device=dev,
                                     dtype=torch.float32)
            gmab = torch.empty((3, g.ci), device=dev, dtype=torch.float32)

    mtot = g.ktaps * cig
    tm_w, tn_w = (32 if mtot <= 32 else 64), _tile_n(cog)
    tiles = g.groups * -(-mtot // tm_w) * -(-cog // tn_w)
    npos = g.rows * g.wout
    splits = min(max(1, _TARGET_BLOCKS // tiles), -(-npos // 256))
    chunk = -(-npos // splits)
    splits = -(-npos // chunk)
    nw = weight.numel()
    ldw = nw + (g.co if has_bias else 0)
    partial_w = torch.empty((splits, ldw), device=dev, dtype=torch.float32)
    gwb = torch.empty((ldw,), device=dev, dtype=torch.float32)
    STAGE_BACKWARD.launch(code, ptr(x), ptr(m), ptr(a), ptr(b), ptr(mask),
                          div, keep, ptr(w), ptr(out), ptr(go), ptr(gsums),
                          ptr(gx), ptr(partial_ab), ptr(gmab),
                          ptr(partial_w), ptr(gwb), ldw, *g, tn_d, grid_x_d,
                          tm_w, tn_w, splits, chunk, stream_ptr(dev))
    gw = gwb[:nw].view(weight.shape)
    return gx, gmab, gw, (gwb[nw:] if has_bias else None)


def _join_launch_shape(h: torch.Tensor) -> Tuple[int, int, int, int]:
    c = h.shape[-1]
    npos = h.numel() // c
    cw = 32 if c > 16 else 16 if c > 8 else 8
    # elementwise work: twice the blocks of a product's launch
    grid_x = min(-(-npos // (256 // cw)),
                 max(1, 2 * _TARGET_BLOCKS // -(-c // cw)))
    return npos, c, cw, grid_x


def _join_args(h, m_h, a_h, b_h, mask, res, m_r, a_r, b_r):
    dev, dt = h.device, h.dtype
    c = h.shape[-1]
    h = h.contiguous()
    res = res.contiguous()
    check_tensor(res, "res", device=dev, dtype=dt, shape=h.shape)
    vh = _prologue(m_h, a_h, b_h, dev, c, "join h")
    if vh[1] is None:
        raise ValueError("join: m_h, a_h, b_h are required")
    vr = _prologue(m_r, a_r, b_r, dev, c, "join res")
    mask, div = _mask_arg(mask, h)
    return h, vh, mask, div, res, vr


def join_forward(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor,
                 m_r=None, a_r=None, b_r=None, *, keep: float = 1.0,
                 act_h: bool = True) -> torch.Tensor:
    """One launch of the forward kernel."""
    h, vh, mask, div, res, vr = _join_args(h, m_h, a_h, b_h, mask, res, m_r,
                                           a_r, b_r)
    npos, c, cw, grid_x = _join_launch_shape(h)
    out = torch.empty_like(h)
    JOIN_FORWARD.launch(dtype_code(h.dtype), ptr(h), *map(ptr, vh), ptr(mask),
                        div, keep, ptr(res), *map(ptr, vr), int(act_h),
                        ptr(out), npos, c, cw, grid_x, stream_ptr(h.device))
    return out


def join_backward(h: torch.Tensor, m_h, a_h, b_h, mask, res: torch.Tensor,
                  m_r, a_r, b_r, go: torch.Tensor, *, keep: float = 1.0,
                  act_h: bool = True):
    """One launch of the backward kernel (and its float64 reduction):
    ``(gh, gres)`` in ``h.dtype`` and ``gvec [2, 3, C]`` fp32, the (g_m,
    g_a, g_b) of the main branch and, with a residual norm, of the
    residual branch."""
    h, vh, mask, div, res, vr = _join_args(h, m_h, a_h, b_h, mask, res, m_r,
                                           a_r, b_r)
    dev = h.device
    go = go.contiguous()
    check_tensor(go, "go", device=dev, dtype=h.dtype, shape=h.shape)
    npos, c, cw, grid_x = _join_launch_shape(h)
    gh, gres = torch.empty_like(h), torch.empty_like(h)
    partial = torch.empty((grid_x, 4, c), device=dev, dtype=torch.float32)
    gvec = torch.empty((2, 3, c), device=dev, dtype=torch.float32)
    JOIN_BACKWARD.launch(dtype_code(h.dtype), ptr(h), *map(ptr, vh),
                         ptr(mask), div, keep, ptr(res), *map(ptr, vr),
                         int(act_h), ptr(go), ptr(gh), ptr(gres),
                         ptr(partial), ptr(gvec), npos, c, cw, grid_x,
                         stream_ptr(dev))
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
